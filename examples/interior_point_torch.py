"""OverSketched Newton inside interior-point methods (paper Sec. 4.3) on
the torch port: (a) a linear program  min c.x  s.t. Ax <= b, and (b) the
Lasso dual.  Both solve a sequence of barrier subproblems with the sketched
Hessian, and print the stage lines of examples/interior_point.py; the same
keys draw the same problems.

  PYTHONPATH=src python examples/interior_point_torch.py [--device cpu]

Runs on the CUDA device unless --device says otherwise.
"""
import argparse

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import (Dataset, LassoDualIPM, LinearProgramIPM,
                              NewtonConfig, OverSketchConfig,
                              oversketched_newton)
from repro_torch.kernels import ops


def main(device) -> None:
    key = prng.PRNGKey(0)

    # ------------------------------------------------------------ LP ------
    n, m = 400, 40
    a_mat = ops.normal(key, (n, m), device=device)
    x_feasible = torch.zeros(m, device=device)
    b = a_mat @ x_feasible + 1.0 + ops.uniform(prng.fold_in(key, 1), (n,),
                                               device=device)
    c = ops.normal(prng.fold_in(key, 2), (m,), device=device)
    data = Dataset(x=a_mat, y=b)

    x = np.zeros(m, np.float32)
    tau = 2.0
    print("LP interior point (barrier stages with OverSketched Newton):")
    for stage in range(4):
        obj = LinearProgramIPM(c=c, tau=tau)
        cfg = NewtonConfig(iters=6, sketch=OverSketchConfig(512, 64, 0.25),
                           coded_block_rows=64, beta=0.1)
        res = oversketched_newton(obj, data, x, cfg, model=None,
                                  device=device)
        x = res.w
        gap = n / tau          # duality-gap bound for the log barrier
        print(f"  tau={tau:7.1f}  c.x={float(c @ x):+.4f}  gap<={gap:.3f}  "
              f"feasible={bool((a_mat @ x < b).all())}")
        tau *= 8.0

    # ---------------------------------------------------- Lasso dual ------
    n2, d2 = 60, 200
    x_mat = ops.normal(prng.fold_in(key, 3), (n2, d2), device=device) * 0.2
    y = ops.normal(prng.fold_in(key, 4), (n2,), device=device)
    lam = 1.5
    ldata = Dataset(x=x_mat, y=y)
    z = np.zeros(n2, np.float32)
    tau = 4.0
    print("\nLasso dual interior point:")
    for stage in range(3):
        obj = LassoDualIPM(lam=lam, tau=tau)
        cfg = NewtonConfig(iters=6, sketch=OverSketchConfig(256, 64, 0.25),
                           coded_block_rows=32, beta=0.1)
        res = oversketched_newton(obj, ldata, z, cfg, model=None,
                                  device=device)
        z = res.w
        viol = float(torch.abs(x_mat.T @ z).max())
        resid = float(0.5 * torch.sum((y - z) ** 2))
        print(f"  tau={tau:6.1f}  0.5||y-z||^2={resid:.4f}"
              f"  max|X^T z|={viol:.4f} (lam={lam})")
        tau *= 10.0
    print("dual feasibility approached: max|X^T z| <= lam at optimum")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    main(resolve_device(parser.parse_args().device))
