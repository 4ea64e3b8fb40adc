"""Quickstart on the GPU: OverSketched Newton on logistic regression through
the torch port, with the Hessian sketch on the hand-written CUDA kernel.

  PYTHONPATH=src python examples/quickstart_torch.py

Needs an NVIDIA GPU (sm_90a) and nvcc; the kernels build on first use
into build/repro_torch_kernels/.
"""
import numpy as np

from repro_torch import prng
from repro_torch.core import (LogisticRegression, NewtonConfig,
                              OverSketchConfig, oversketched_newton)
from repro_torch.data import make_logistic_dataset

# a synthetic classification problem (paper Sec. 5.1 generative model),
# drawn on the card; the same key gives the JAX quickstart's features
data = make_logistic_dataset(prng.PRNGKey(0), n=4000, d=150, n_test=1000)
objective = LogisticRegression(lam=1e-4)

config = NewtonConfig(
    iters=10,
    # OverSketch: sketch dim 10*d, 128-wide Count-Sketch blocks, 25% extra
    # blocks so up to 1-in-4 straggling workers cost nothing (Alg. 2)
    sketch=OverSketchConfig(sketch_dim=1536, block_size=128,
                            straggler_tolerance=0.25),
    gradient_policy="coded",       # 2D-product-coded exact gradients (Alg. 1)
    use_kernels=True,              # fused count-sketch Gram CUDA kernel
    track_test_error=True,
)

result = oversketched_newton(objective, data, np.zeros(150, np.float32),
                             config)

print("iter    f(w)        ||grad||     sim_time  test_err")
for i in range(len(result.history["fval"])):
    h = result.history
    print(f"{h['iter'][i]:3d}  {h['fval'][i]:.6f}  {h['gnorm'][i]:.2e}"
          f"  {h['time'][i]:8.2f}  {h['test_error'][i]:.4f}")
