"""The paper's technique on the model zoo, on the torch port: a softmax
readout head trained on frozen LM-backbone features with OverSketched
Newton (weakly convex => Newton-MR update, Thm 3.3 regime); the same run
as examples/osn_lm_head.py.

  PYTHONPATH=src python examples/osn_lm_head_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.configs import smoke_config
from repro_torch.models.registry import ModelBundle
from repro_torch.training.osn_head import extract_features, train_osn_head

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cpu, or the CUDA device")
device = resolve_device(ap.parse_args().device)

K = 4                      # synthetic downstream classes
N = 1200                   # probe training examples

cfg = smoke_config("qwen3-4b")
bundle = ModelBundle(cfg)
params = bundle.init(prng.PRNGKey(0), device=device)

# synthetic "documents": class-conditioned token distributions
rs = np.random.RandomState(0)
labels = rs.randint(0, K, N)
tokens = (rs.randint(1, cfg.vocab_size // K - 1, (N, 32)) +
          labels[:, None] * (cfg.vocab_size // K)).astype(np.int32)

features = torch.cat([
    extract_features(bundle, params,
                     torch.from_numpy(tokens[i:i + 64]).to(device))
    for i in range(0, N, 64)])
onehot = prng.one_hot(torch.from_numpy(labels).to(device), K)

w, hist = train_osn_head(features, onehot, num_classes=K, iters=8,
                         use_kernels=device.type == "cuda")
pred = (features @ w.reshape(K, -1).T).argmax(dim=1).cpu().numpy()
acc = float((pred == labels).mean())
print("iter  f(W)      ||grad||   sim_time")
for i in range(len(hist["fval"])):
    print(f"{i:3d}  {hist['fval'][i]:.5f}  {hist['gnorm'][i]:.2e}"
          f"  {hist['time'][i]:7.2f}")
print(f"probe train accuracy: {acc:.3f} (chance {1/K:.3f})")
