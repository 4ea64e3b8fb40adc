"""Fig. 9: softmax regression (weakly convex, EMNIST profile) — gradient
descent vs exact Newton vs OverSketched Newton with the Newton-MR update;
port of ``benchmarks/fig9_softmax.py``.  Paper headline: OSN ~75% faster
than GD, ~50% faster than exact Newton."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import (NewtonConfig, OverSketchConfig,
                              SoftmaxRegression, oversketched_newton)
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import make_softmax_dataset
from repro_torch.optim import FirstOrderConfig, exact_newton, first_order


def _fig9(data, iters: int, gd_iters: int):
    """OSN (pinv direction) and exact Newton for ``iters`` iterations, gd
    (60 workers) for ``gd_iters``; the classes are the one-hot labels'."""
    d = data.x.shape[1]
    dev = data.x.device
    k = data.y.shape[1]
    obj = SoftmaxRegression(num_classes=k)
    w0 = torch.zeros(k * d, device=dev)
    model = StragglerModel()

    dk = d * k
    sk = OverSketchConfig(((6 * dk) // 256 + 1) * 256, 256, 0.25)
    osn = oversketched_newton(
        obj, data, w0, NewtonConfig(iters=iters, sketch=sk, solver="pinv",
                                    unit_step=False, coded_block_rows=256,
                                    use_kernels=True),
        model=model, device=dev).history
    exact = exact_newton(obj, data, w0, iters=iters, model=model,
                         solver="pinv", unit_step=False, device=dev)
    gd = first_order(obj, data, w0,
                     FirstOrderConfig(iters=gd_iters, method="gd",
                                      policy="ignore", num_workers=60),
                     model=model, device=dev)

    # fixed moderate gradient-norm target (the paper plots ||grad f||; the
    # sketch's eps-noise floor sits well below this threshold)
    g_target = 3e-2
    rows = []
    for name, h in [("osn_newton_mr", osn), ("exact_newton", exact),
                    ("gradient_descent", gd)]:
        t = float("inf")
        for g, tt in zip(h["gnorm"], h["time"]):
            if g <= g_target:
                t = tt
                break
        rows.append({
            "name": f"fig9_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_gtarget={t:.2f};"
                        f"final_gnorm={h['gnorm'][-1]:.2e};"
                        f"final_f={h['fval'][-1]:.5f}"),
        })
    return rows


def run(quick: bool = True, device=None):
    # EMNIST stand-in with the paper's n >> sketch-dim regime
    data = make_softmax_dataset(prng.PRNGKey(3), 6000, 98, 10,
                                device=device)
    return _fig9(data, 6 if quick else 10, 30 if quick else 60)
