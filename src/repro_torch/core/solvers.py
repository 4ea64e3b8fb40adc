"""Linear solvers for the Newton direction; port of
``repro/core/solvers.py``.  Strongly convex: Cholesky or CG.  Weakly
convex: eigendecomposition pseudo-inverse or MINRES.  ``lax.scan`` loops
become Python loops with the same fixed trip counts and masking."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.obs import host


def psd_solve(h: torch.Tensor, g: torch.Tensor,
              jitter: float = 1e-9) -> torch.Tensor:
    """Solve H p = g for symmetric PD H via Cholesky with a tiny jitter;
    a batch of systems (K, d, d) shares one g and gives (K, d)."""
    d = h.shape[-1]
    # torch reads the factorization's status back to the host.
    with host.TRACER.sync("cholesky"):
        chol = torch.linalg.cholesky(
            h + jitter * torch.eye(d, dtype=h.dtype, device=h.device))
    rhs = g.expand(h.shape[:-1]).unsqueeze(-1)
    return torch.cholesky_solve(rhs, chol).squeeze(-1)


def psd_pinv_solve(h: torch.Tensor, g: torch.Tensor,
                   rtol: float = 1e-6) -> torch.Tensor:
    """Moore-Penrose solve H^+ g via symmetric eigendecomposition."""
    # torch reads the solver's status back to the host.
    with host.TRACER.sync("eigh"):
        evals, evecs = torch.linalg.eigh(h)
    cutoff = rtol * evals.abs().max()
    inv = torch.where(evals.abs() > cutoff, 1.0 / evals,
                      torch.zeros_like(evals))
    return evecs @ (inv * (evecs.T @ g))


def conjugate_gradient(matvec: Callable[[torch.Tensor], torch.Tensor],
                       b: torch.Tensor, x0: torch.Tensor, iters: int = 50,
                       tol: float = 1e-10) -> torch.Tensor:
    """Plain CG for PD systems (matvec-only access), fixed trip count."""
    x, r = x0, b - matvec(x0)
    p, rs = r, r @ r
    for _ in range(iters):
        hp = matvec(p)
        denom = p @ hp
        alpha = torch.where(denom > 0, rs / denom.clamp_min(1e-30),
                            torch.zeros_like(rs))
        x = x + alpha * p
        r = r - alpha * hp
        rs_new = r @ r
        beta = rs_new / rs.clamp_min(1e-30)
        p = (rs_new > tol).to(b.dtype) * (r + beta * p)
        rs = rs_new
    return x


def minres(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
           iters: int = 50) -> torch.Tensor:
    """MINRES via an explicit re-orthogonalized Lanczos basis: builds V
    ((iters+1), d) and the tridiagonal T ((iters+1), iters), solves
    min ||T y - beta1 e1|| and returns V[:iters]^T y."""
    d = b.shape[0]
    iters = min(iters, d)           # the Krylov space cannot exceed dim(b)
    beta1 = torch.linalg.norm(b)
    vs = torch.zeros((iters + 1, d), dtype=b.dtype, device=b.device)
    vs[0] = b / beta1.clamp_min(1e-30)
    alphas = torch.zeros(iters, dtype=b.dtype, device=b.device)
    betas = torch.zeros(iters + 1, dtype=b.dtype, device=b.device)
    live = torch.ones((), dtype=torch.bool, device=b.device)
    idx = torch.arange(iters + 1, device=b.device)
    for i in range(iters):
        v_i = vs[i]
        hv = matvec(v_i)
        alpha = v_i @ hv
        hv = hv - alpha * v_i - betas[i] * vs[i - 1]
        # Full re-orthogonalization against the basis built so far.
        basis = vs * (idx <= i)[:, None].to(b.dtype)
        hv = hv - basis.T @ (basis @ hv)
        beta = torch.linalg.norm(hv)
        # Lanczos breakdown: the Krylov space is exhausted; zero the rest.
        live_next = live & (beta > 1e-6 * beta1)
        lf, nf = live.to(b.dtype), live_next.to(b.dtype)
        vs[i + 1] = lf * nf * hv / beta.clamp_min(1e-30)
        alphas[i] = lf * alpha
        betas[i + 1] = lf * nf * beta
        live = live_next
    k = torch.arange(iters, device=b.device)
    t = torch.zeros((iters + 1, iters), dtype=b.dtype, device=b.device)
    t[k, k] = alphas
    t[k + 1, k] = betas[1:iters + 1]
    t[k[:-1], k[1:]] = betas[1:iters]
    rhs = torch.zeros(iters + 1, dtype=b.dtype, device=b.device)
    rhs[0] = beta1
    # Least squares with singular values below 1e-6 * max dropped, as the
    # reference's lstsq(rcond=1e-6).
    y = torch.linalg.pinv(t, rtol=1e-6) @ rhs
    return vs[:iters].T @ y
