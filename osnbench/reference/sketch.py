"""The sketched Hessian in plain PyTorch: draws, the blocks S_k^T A of a
problem's Hessian square root, and their masked Gram.

A is never formed.  Sample n's rows of A (one for logistic regression, K
for softmax) are ``sum_i coef[n, c, i] e_i (x) x_n``: class-major columns,
as the paper's dK-dimensional softmax Hessian (Sec. 4.2) lays them out.
So a block S_k^T A of b rows is a (b R) x n matrix Q_k times X, where R is
the rows a sample has, and the Gram is

    H_hat = (1 / L) sum over the L live blocks of (S_k^T A)^T (S_k^T A).

Count sketch (Eq. 4): S_k^T[j, r] = sigma[k, r] [h[k, r] = j].  SRHT:
S_k^T[j, r] = (-1)^popcount(rows[k, j] & r) sigma[k, r] / sqrt(b), the
orthonormal Sylvester-Hadamard mix over n padded to a power of two, b rows
sampled, scaled by sqrt(n_pad / b).  Each block is unbiased alone, so any
live subset is an unbiased sketch.

``rnd`` rounds every product's operands (the control's TF32); the judge
works in float64 with none.  This module imports nothing of the program
under test.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

GROUP = 8                   # sketch blocks a product
BUDGET = 1 << 30            # bytes of one group's Q for one chunk of rows


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def rows_per_sample(cfg: dict) -> int:
    return int(cfg["classes"]) if cfg["objective"] == "softmax" else 1


def coef(cfg: dict, xb: torch.Tensor, yb: torch.Tensor, w: torch.Tensor,
         n: int) -> torch.Tensor:
    """(rows, R, R): coef[s, c, i], sample s's row c of A on class i's
    columns, at the iterate w, in xb's dtype by the plain formulas;
    ``n`` is the problem's row count."""
    if cfg["objective"] == "logistic":
        # sig(y x.w) (1 - sig(y x.w)): in float32 a row whose margin y x.w
        # passes about 16.6 rounds its sigmoid to 1 and drops out of A
        s = torch.sigmoid(yb * (xb @ w))
        return torch.sqrt(s * (1.0 - s) / n)[:, None, None]
    if cfg["objective"] == "softmax":
        k = int(cfg["classes"])
        p = torch.softmax(xb @ w.reshape(k, xb.shape[1]).T, -1)   # (rows, K)
        eye = torch.eye(k, dtype=p.dtype, device=p.device)
        # M[i, c] = sqrt(p_c) (delta_ic - p_i), so M M^T = diag(p) - p p^T
        m = torch.sqrt(p)[:, None, :] * (eye[None] - p[:, :, None])
        return m.transpose(1, 2) / math.sqrt(n)
    raise ValueError(f"no Hessian square root for {cfg['objective']!r}")


def _parity(v: torch.Tensor) -> torch.Tensor:
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def _q(draws: Dict, blocks: torch.Tensor, cf: torch.Tensor,
       r0: int) -> torch.Tensor:
    """(G, b, R, rows): Q of the blocks ``blocks`` over the chunk of
    samples that starts at sample ``r0`` (A rows r0 R on)."""
    rows, r, _ = cf.shape
    b, dev, dt = int(draws["block_size"]), cf.device, cf.dtype
    # the draws are on cf's device
    lo, hi = r0 * r, (r0 + rows) * r
    sigma = draws["sigma"][:, lo:hi][blocks].to(dt)
    g = sigma.shape[0]
    if draws["family"] == "count":
        h = draws["h"][:, lo:hi][blocks].long()
        q = torch.zeros((g, b, rows, r), dtype=dt, device=dev)
        h, sigma = h.view(g, rows, r), sigma.view(g, rows, r)
        for c in range(r):
            vals = sigma[:, :, c, None] * cf[None, :, c, :]     # (G, rows, R)
            q.scatter_add_(1, h[:, None, :, c, None].expand(g, 1, rows, r),
                           vals[:, None])
        return q.permute(0, 1, 3, 2)
    if draws["family"] == "srht":
        sel = draws["rows"][blocks].long()
        idx = torch.arange(lo, hi, device=dev)
        sign = 1.0 - 2.0 * _parity(sel[:, :, None] & idx).to(dt)
        t = sign * sigma[:, None, :] / math.sqrt(b)          # (G, b, rows R)
        return torch.einsum("gbnc,nci->gbin", t.view(g, b, rows, r), cf)
    raise ValueError(f"no sketch family {draws['family']!r}")


def blocks(cfg: dict, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
           draws: Dict, dtype=torch.float64, rnd: Callable = identity,
           coef_dtype=None) -> torch.Tensor:
    """S_k^T A of every live block: (L, b, R d) in ``dtype`` on x's
    device, A at the iterate w, its coefficients formed in ``coef_dtype``
    (``dtype`` when None)."""
    n, d = x.shape
    r, b = rows_per_sample(cfg), int(draws["block_size"])
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
        cf = coef(cfg, xb.to(cdt), y[s0:s0 + chunk].to(cdt), wc, n).to(dtype)
        xb = rnd(xb.to(dtype))
        for g0 in range(0, len(live), GROUP):
            grp = live[g0:g0 + GROUP]
            q = rnd(_q(draws, grp, cf, s0)).reshape(len(grp) * b * r, -1)
            out[g0:g0 + len(grp)] += (q @ xb).view(len(grp), b * r, d)
    return out.view(len(live), b, r * d)


def gram(at: torch.Tensor, rnd: Callable = identity) -> torch.Tensor:
    """The masked Gram of the live blocks (L, b, D): (D, D)."""
    flat = rnd(at.reshape(-1, at.shape[-1]))
    return flat.T @ flat / at.shape[0]


def draw(family: str, total_blocks: int, block_size: int, n_rows: int,
         gen: torch.Generator, device) -> Dict:
    """A fresh draw of every block, all live: the control's own sketch."""
    shape = (total_blocks, n_rows)
    sigma = 2.0 * torch.randint(0, 2, shape, generator=gen,
                                device=device).float() - 1.0
    out = {"family": family, "block_size": block_size, "sigma": sigma,
           "live": torch.ones(total_blocks, dtype=torch.bool)}
    if family == "count":
        out["h"] = torch.randint(0, block_size, shape, generator=gen,
                                 device=device, dtype=torch.int32)
    elif family == "srht":
        n_pad = 1 << max(0, (n_rows - 1).bit_length())
        out["rows"] = torch.randint(0, n_pad, (total_blocks, block_size),
                                    generator=gen, device=device,
                                    dtype=torch.int32)
    else:
        raise ValueError(f"no sketch family {family!r}")
    return out
