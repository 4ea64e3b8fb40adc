"""Fig. 7: EPSILON-profile logistic regression, train AND test error vs
simulated time; port of ``benchmarks/fig7_epsilon.py``.  Paper headline:
OverSketched Newton >= 46% faster than the best baseline; gradient coding
loses to uncoded due to replication comm.

Extended with a sketch-family sweep (the ``sketching`` registry): the same
Newton loop is scored per family in simulated wall-clock and solution
quality, one JSON row each."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import best_f, json_row, time_to_target
from repro_torch.core import (LogisticRegression, NewtonConfig,
                              OverSketchConfig, oversketched_newton)
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import profile_dataset
from repro_torch.optim import GiantConfig, exact_newton, giant
from repro_torch.sketching import available as sketch_families


def _fig7(data, iters: int, fam_iters: int):
    """OSN and exact Newton for ``iters`` iterations, GIANT (100 workers,
    wait-all and gcode) for ``iters + 6``, then every registered sketch
    family for ``fam_iters``."""
    d = data.x.shape[1]
    dev = data.x.device
    obj = LogisticRegression(lam=1e-5)
    w0 = torch.zeros(d, device=dev)
    model = StragglerModel()

    sk = OverSketchConfig(((15 * d) // 256 + 1) * 256, 256, 0.25)
    osn = oversketched_newton(
        obj, data, w0,
        NewtonConfig(iters=iters, sketch=sk, unit_step=False,
                     coded_block_rows=256, track_test_error=True,
                     use_kernels=True),
        model=model, device=dev).history
    exact = exact_newton(obj, data, w0, iters=iters, model=model,
                         unit_step=False, track_test_error=True, device=dev)
    g_wait = giant(obj, data, w0,
                   GiantConfig(iters=iters + 6, num_workers=100,
                               policy="wait_all", unit_step=False,
                               track_test_error=True),
                   model=model, device=dev)
    g_code = giant(obj, data, w0,
                   GiantConfig(iters=iters + 6, num_workers=100,
                               policy="gcode", gcode_redundancy=4,
                               unit_step=False, track_test_error=True),
                   model=model, device=dev)

    target = best_f(osn, exact, g_wait, g_code)
    rows = []
    for name, h in [("osn", osn), ("exact_newton", exact),
                    ("giant_waitall", g_wait), ("giant_gcode", g_code)]:
        t = time_to_target(h, target)
        rows.append({
            "name": f"fig7_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};"
                        f"test_err={h['test_error'][-1]:.4f};"
                        f"final_f={h['fval'][-1]:.5f}"),
        })
    # paper observation: gcode slower than wait-all per-iteration on EPSILON
    rows.append({
        "name": "fig7_gcode_vs_waitall_periter", "us": 0.0,
        "derived": (f"gcode_t={g_code['time'][-1]:.1f};"
                    f"waitall_t={g_wait['time'][-1]:.1f}"),
    })

    # --- sketch-family sweep: head-to-head simulated time + quality --------
    for fam in sketch_families():
        h = oversketched_newton(
            obj, data, w0,
            NewtonConfig(iters=fam_iters, sketch=sk, unit_step=False,
                         coded_block_rows=256, sketch_family=fam,
                         track_test_error=True, use_kernels=True),
            model=model, device=dev).history
        rows.append(json_row(
            f"fig7_family_{fam}", h["time"][-1] * 1e6,
            family=fam, sim_t=h["time"][-1], final_f=h["fval"][-1],
            gnorm=h["gnorm"][-1], test_err=h["test_error"][-1]))
    return rows


def run(quick: bool = True, device=None):
    data = profile_dataset("epsilon", prng.PRNGKey(1), device=device)
    return _fig7(data, 8 if quick else 14, 6 if quick else 10)
