"""The sketched Hessian in plain PyTorch: the blocks S_k^T A of a problem's
Hessian square root under a family's draws, and their masked Gram.

A is never formed.  Sample n's rows of A (R of them: one for logistic
regression, K for softmax; the objective's ``rows_per_sample``) are
``sum_i coef[n, c, i] e_i (x) x_n``: class-major columns, as the paper's
dK-dimensional softmax Hessian (Sec. 4.2) lays them out, with the
objective's ``coef``.  So a block S_k^T A of b rows is a (b R) x n matrix
Q_k times X, where the family's ``q`` forms Q_k, and the Gram is

    H_hat = (1 / L) sum over the L live blocks of (S_k^T A)^T (S_k^T A).

Each family's block is unbiased alone, so any live subset is an unbiased
sketch.  ``rnd`` rounds every product's operands (the control's TF32); the
judge works in float64 with none.  This module imports nothing of the
program under test.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

GROUP = 8                   # sketch blocks a product
BUDGET = 1 << 30            # bytes of one group's Q for one chunk of rows


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def signs(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Rademacher draws, +-1.0 in float32."""
    return 2.0 * torch.randint(0, 2, shape, generator=gen,
                               device=device).float() - 1.0


def segment_q(h: torch.Tensor, sigma: torch.Tensor, cf: torch.Tensor,
              b: int) -> torch.Tensor:
    """(G, b, R, rows): Q of G blocks of signed segment sums over a chunk
    of samples, S^T[j, e] = sum_t sigma[t, e] [h[t, e] = j] over the
    chunk's rows e of A and a block's L layers t: ``h`` (long) and
    ``sigma`` (cf's dtype) (G, L, rows R), ``cf`` the chunk's coefficients
    (rows, R, R)."""
    rows, r, _ = cf.shape
    g, layers = sigma.shape[:2]
    q = torch.zeros((g, b, rows, r), dtype=cf.dtype, device=cf.device)
    h = h.view(g, layers, rows, r)
    sigma = sigma.view(g, layers, rows, r)
    for t in range(layers):
        for c in range(r):
            vals = sigma[:, t, :, c, None] * cf[None, :, c, :]  # (G, rows, R)
            q.scatter_add_(1, h[:, t, None, :, c, None].expand(g, 1, rows, r),
                           vals[:, None])
    return q.permute(0, 1, 3, 2)


def blocks(cell: Dict, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
           draws: Dict, dtype=torch.float64, rnd: Callable = identity,
           coef_dtype=None) -> torch.Tensor:
    """S_k^T A of every live block under the cell's family's ``draws``:
    (L, b, R d) in ``dtype`` on x's device, A the cell's objective's at the
    iterate w, its coefficients formed in ``coef_dtype`` (``dtype`` when
    None)."""
    cfg, obj, fam = cell["config"], cell["objective"], cell["family"]
    n, d = x.shape
    r, b = obj.rows_per_sample(cfg), int(draws["block_size"])
    draws = {k: v.to(x.device) if torch.is_tensor(v) else v
             for k, v in draws.items()}
    live = torch.nonzero(draws["live"]).flatten()
    w = w.to(device=x.device, dtype=dtype)
    out = torch.zeros((len(live), b * r, d), dtype=dtype, device=x.device)
    size = torch.finfo(dtype).bits // 8
    chunk = max(1, BUDGET // (GROUP * b * r * size))
    cdt = dtype if coef_dtype is None else coef_dtype
    wc = w.to(cdt)
    for s0 in range(0, n, chunk):
        xb = x[s0:s0 + chunk]
        cf = obj.coef(cfg, xb.to(cdt), y[s0:s0 + chunk].to(cdt), wc,
                      n).to(dtype)
        xb = rnd(xb.to(dtype))
        for g0 in range(0, len(live), GROUP):
            grp = live[g0:g0 + GROUP]
            q = rnd(fam.q(draws, grp, cf, s0)).reshape(len(grp) * b * r, -1)
            out[g0:g0 + len(grp)] += (q @ xb).view(len(grp), b * r, d)
    return out.view(len(live), b, r * d)


def gram(at: torch.Tensor, rnd: Callable = identity) -> torch.Tensor:
    """The masked Gram of the live blocks (L, b, D): (D, D)."""
    flat = rnd(at.reshape(-1, at.shape[-1]))
    return flat.T @ flat / at.shape[0]
