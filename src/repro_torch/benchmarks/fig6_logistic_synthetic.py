"""Fig. 6: logistic regression on the synthetic dataset — OverSketched Newton
vs GIANT (wait-all / gradient-coding / ignore-stragglers) vs exact Newton
with speculative execution; port of
``benchmarks/fig6_logistic_synthetic.py``.  Scored in simulated wall-clock
(same straggler model for every scheme); the paper's qualitative result to
reproduce:

  uncoded (wait-all) worst;  mini-batch beats gradient coding;  exact Newton
  beats GIANT;  OverSketched Newton fastest overall (~2x vs exact Newton).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import best_f, time_to_target
from repro_torch.core import (LogisticRegression, NewtonConfig,
                              OverSketchConfig, oversketched_newton)
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import make_logistic_dataset
from repro_torch.optim import GiantConfig, exact_newton, giant

#: The five runs, in the order the body makes them.
RUNS = ("osn", "exact_newton_spec", "giant_waitall", "giant_gcode",
        "giant_minibatch")


def _fig6(data, iters: int, giant_iters: int, observe=None):
    """The comparison on ``data``: OverSketched Newton and exact Newton for
    ``iters`` iterations, GIANT under each policy for ``giant_iters``, on
    the data's device.  ``observe(name, run)`` makes each run (``run()``
    returns its history); a caller passes its own to measure them."""
    observe = observe or (lambda name, run: run())
    d = data.x.shape[1]
    dev = data.x.device
    obj = LogisticRegression(lam=1e-5)
    w0 = torch.zeros(d, device=dev)
    model = StragglerModel()

    sk = OverSketchConfig(sketch_dim=((10 * d) // 256 + 1) * 256,
                          block_size=256, straggler_tolerance=0.25)
    osn = observe("osn", lambda: oversketched_newton(
        obj, data, w0, NewtonConfig(iters=iters, sketch=sk, unit_step=False,
                                    coded_block_rows=256,
                                    use_kernels=True),
        model=model, device=dev).history)
    exact = observe("exact_newton_spec", lambda: exact_newton(
        obj, data, w0, iters=iters, model=model, unit_step=False,
        device=dev))

    def giant_run(policy):
        return lambda: giant(obj, data, w0,
                             GiantConfig(iters=giant_iters, num_workers=60,
                                         policy=policy, unit_step=False),
                             model=model, device=dev)
    g_wait = observe("giant_waitall", giant_run("wait_all"))
    g_code = observe("giant_gcode", giant_run("gcode"))
    g_ign = observe("giant_minibatch", giant_run("ignore"))

    target = best_f(osn, exact, g_wait, g_code, g_ign)
    out = []
    for name, h in zip(RUNS, (osn, exact, g_wait, g_code, g_ign)):
        t = time_to_target(h, target)
        out.append({
            "name": f"fig6_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f};"
                        f"final_gnorm={h['gnorm'][-1]:.2e}"),
        })
    # headline check: osn faster than exact newton to the common target
    t_osn = time_to_target(osn, target)
    t_ex = time_to_target(exact, target)
    out.append({"name": "fig6_speedup_osn_vs_exact", "us": 0.0,
                "derived": f"ratio={t_ex / max(t_osn, 1e-9):.2f}x"})
    return out


def run(quick: bool = True, device=None):
    n, d = (12_000, 400) if quick else (40_000, 1000)
    data = make_logistic_dataset(prng.PRNGKey(0), n, d, n_test=1000,
                                 cond=10.0, sorted_layout=True,
                                 device=device)
    iters = 8 if quick else 12
    return _fig6(data, iters, iters + 6)
