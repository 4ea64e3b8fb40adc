"""Distributed line search (paper Sec. 3.2); port of
``repro/core/linesearch.py``.

Workers evaluate the objective at every candidate step in
S = {4^0, 4^-1, ..., 4^-5}; the master picks the largest step satisfying
the Armijo condition (Eq. 5) or, on the weakly convex path, the gradient
norm condition (Eq. 6).  The candidates are one batch dimension where the
reference vmaps.
"""
from __future__ import annotations

from typing import Tuple

import torch

DEFAULT_CANDIDATES = tuple(4.0 ** (-i) for i in range(6))   # 1, ..., 4^-5


def _first_ok(ok: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """The first (largest) candidate that qualifies, else the smallest."""
    idx = torch.argmax(ok.to(torch.int8))
    return torch.where(ok.any(), candidates[idx], candidates[-1])


def armijo_select(f_trials: torch.Tensor, f0: torch.Tensor, gtp: torch.Tensor,
                  candidates: torch.Tensor, beta: float = 0.1) -> torch.Tensor:
    """Largest alpha with f(w + a p) <= f(w) + a * beta * p.g (Eq. 5)."""
    ok = (f_trials <= f0 + candidates * beta * gtp) & torch.isfinite(f_trials)
    return _first_ok(ok, candidates)


def gradnorm_select(gnorm2_trials: torch.Tensor, gnorm2_0: torch.Tensor,
                    ptHg: torch.Tensor, candidates: torch.Tensor,
                    beta: float = 0.1) -> torch.Tensor:
    """Largest alpha with ||g(w + a p)||^2 <= ||g||^2 + 2 a beta p^T H g
    (Eq. 6)."""
    ok = ((gnorm2_trials <= gnorm2_0 + 2.0 * candidates * beta * ptHg)
          & torch.isfinite(gnorm2_trials))
    return _first_ok(ok, candidates)


def linesearch_strongly_convex(objective, data, w: torch.Tensor,
                               p: torch.Tensor, g: torch.Tensor,
                               beta: float = 0.1,
                               candidates: Tuple[float, ...] = DEFAULT_CANDIDATES
                               ) -> torch.Tensor:
    cand = torch.tensor(candidates, dtype=w.dtype, device=w.device)
    f0 = objective.value(w, data)
    f_trials = objective.value(w[None] + cand[:, None] * p[None], data)
    return armijo_select(f_trials, f0, p @ g, cand, beta)


def linesearch_weakly_convex(objective, data, w: torch.Tensor,
                             p: torch.Tensor, g: torch.Tensor,
                             h_hat_g: torch.Tensor, beta: float = 0.1,
                             candidates: Tuple[float, ...] = DEFAULT_CANDIDATES
                             ) -> torch.Tensor:
    """Trial-point gradient norms, the sketched Hessian in the RHS."""
    cand = torch.tensor(candidates, dtype=w.dtype, device=w.device)
    trials = []
    for a in cand:
        gt = objective.gradient(w + a * p, data)
        trials.append(gt @ gt)
    return gradnorm_select(torch.stack(trials), g @ g, p @ h_hat_g, cand,
                           beta)


def distributed_f_trials(objective, data_local, w: torch.Tensor,
                         p: torch.Tensor, candidates: torch.Tensor,
                         group=None) -> torch.Tensor:
    """Per-rank partial objective values at the trial points, summed over
    the ranks of ``group`` (the reference's ``axis``).  The objective
    must be a mean over samples plus a replicated regularizer: each
    rank's value is weighted by its shard size, and the sum divided by the
    summed count."""
    from repro_torch.distributed.collectives import psum_
    n_local = data_local.x.shape[0]
    trials = objective.value(w[None] + candidates[:, None] * p[None],
                             data_local) * n_local
    n = psum_(torch.tensor(float(n_local), dtype=torch.float32,
                           device=trials.device), group)
    return psum_(trials, group) / n
