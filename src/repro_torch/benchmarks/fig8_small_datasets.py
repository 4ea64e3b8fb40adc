"""Fig. 8: WEBPAGE and a9a profiles — OverSketched Newton vs exact Newton vs
GIANT; port of ``benchmarks/fig8_small_datasets.py``.  Paper headline: OSN
>= ~25% faster than exact Newton, ~75% vs GIANT."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import best_f, time_to_target
from repro_torch.core import (LogisticRegression, NewtonConfig,
                              OverSketchConfig, oversketched_newton)
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import profile_dataset
from repro_torch.optim import GiantConfig, exact_newton, giant


def _one(profile: str, data, iters: int):
    """One profile's rows: OSN and exact Newton for ``iters`` iterations,
    GIANT (30 workers) for ``iters + 5``."""
    d = data.x.shape[1]
    dev = data.x.device
    obj = LogisticRegression(lam=1e-5)
    w0 = torch.zeros(d, device=dev)
    model = StragglerModel()

    sk = OverSketchConfig(((10 * d) // 128 + 1) * 128, 128, 0.25)
    osn = oversketched_newton(
        obj, data, w0, NewtonConfig(iters=iters, sketch=sk, unit_step=False,
                                    coded_block_rows=128,
                                    use_kernels=True),
        model=model, device=dev).history
    exact = exact_newton(obj, data, w0, iters=iters, model=model,
                         unit_step=False, device=dev)
    g = giant(obj, data, w0, GiantConfig(iters=iters + 5, num_workers=30,
                                         unit_step=False),
              model=model, device=dev)
    target = best_f(osn, exact, g)
    rows = []
    for name, h in [("osn", osn), ("exact_newton", exact), ("giant", g)]:
        t = time_to_target(h, target)
        rows.append({
            "name": f"fig8_{profile}_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f}",
        })
    return rows


def run(quick: bool = True, device=None):
    iters = 7 if quick else 12
    return [r for profile in ("webpage", "a9a")
            for r in _one(profile, profile_dataset(
                profile, prng.PRNGKey(2), device=device), iters)]
