"""Exact Newton baseline (paper Figs. 6-10); port of
``repro/optim/exact_newton.py``: the full Hessian computed distributedly
with speculative-execution straggler mitigation, i.e. OverSketched
Newton's loop with ``hessian_policy="exact_speculative"``."""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import newton, straggler
from repro_torch.core.objectives import Dataset


def exact_newton(objective, data: Dataset, w0,
                 iters: int = 20, gradient_policy: str = "coded",
                 seed: int = 0, unit_step: bool = True,
                 solver: str = "auto",
                 model: Optional[straggler.StragglerModel] = straggler.StragglerModel(),
                 track_test_error: bool = False,
                 device=None) -> Dict[str, List[float]]:
    """The Newton loop's history with the final iterate under ``"w"``.
    Runs on CUDA unless ``device`` says otherwise."""
    cfg = newton.NewtonConfig(
        iters=iters, hessian_policy="exact_speculative",
        gradient_policy=gradient_policy, unit_step=unit_step, solver=solver,
        seed=seed, track_test_error=track_test_error)
    res = newton.oversketched_newton(objective, data, w0, cfg, model=model,
                                     device=device)
    hist = res.history
    hist["w"] = res.w
    return hist
