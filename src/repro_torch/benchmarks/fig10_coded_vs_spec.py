"""Fig. 10: straggler mitigation schemes head-to-head — coded computing vs
speculative execution, applied independently to the gradient phase and the
Hessian phase (2x2 grid like the paper's figure); port of
``benchmarks/fig10_coded_vs_spec.py``."""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import best_f, time_to_target
from repro_torch.core import (LogisticRegression, NewtonConfig,
                              OverSketchConfig, oversketched_newton)
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import make_logistic_dataset

CASES = {
    "grad_coded_hess_sketch": dict(gradient_policy="coded",
                                   hessian_policy="oversketch"),
    "grad_spec_hess_sketch": dict(gradient_policy="speculative",
                                  hessian_policy="oversketch"),
    "grad_coded_hess_exact_spec": dict(gradient_policy="coded",
                                       hessian_policy="exact_speculative"),
    "grad_spec_hess_exact_spec": dict(gradient_policy="speculative",
                                      hessian_policy="exact_speculative"),
}


def _fig10(data, iters: int):
    """The 2x2 grid on ``data``, ``iters`` iterations each."""
    d = data.x.shape[1]
    obj = LogisticRegression(lam=1e-5)
    w0 = torch.zeros(d, device=data.x.device)
    model = StragglerModel()
    sk = OverSketchConfig(((10 * d) // 256 + 1) * 256, 256, 0.25)

    hists = {}
    for name, kw in CASES.items():
        cfg = NewtonConfig(iters=iters, sketch=sk, unit_step=False,
                           coded_block_rows=256, use_kernels=True,
                           **kw)
        hists[name] = oversketched_newton(obj, data, w0, cfg, model=model,
                                          device=data.x.device).history
    target = best_f(*hists.values())
    rows = []
    for name, h in hists.items():
        t = time_to_target(h, target)
        rows.append({
            "name": f"fig10_{name}",
            "us": (t if t != float("inf") else h["time"][-1]) * 1e6,
            "derived": (f"t_to_target={t:.2f};final_f={h['fval'][-1]:.5f};"
                        f"usd={h['cost'][-1]:.4f}"),
        })
    return rows


def run(quick: bool = True, device=None):
    n, d = (12_000, 400) if quick else (30_000, 1000)
    data = make_logistic_dataset(prng.PRNGKey(4), n, d, cond=10.0,
                                 sorted_layout=True, device=device)
    return _fig10(data, 7 if quick else 10)
