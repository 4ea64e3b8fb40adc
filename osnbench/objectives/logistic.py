"""Logistic regression with a ridge term (arXiv:1903.08857 Sec. 5, Fig. 6):
f(w) = mean log(1 + exp(-y x.w)) + lam / 2 ||w||^2 over n rows x of d
features, labels y in {-1, +1}.  Its configuration gives n, d, lam, cond
and sorted_layout.  Strongly convex: the port's ``auto`` solver is
Cholesky and its line search Armijo's.

What the harness asks of an objective is listed in ``osnbench/README.md``.
This module imports nothing of the program: ``program`` is handed the
port's ``core``.
"""
from __future__ import annotations

import torch

from osnbench.counts import CANDIDATES
from osnbench.datagen import ROWS, generator

AUTO_SOLVER = "chol"


def generate(cfg: dict, seed: int, device):
    """(x (n, d) float32, y (n,) float32 in {-1, +1}), the paper's
    synthetic recipe (Sec. 5.1, as ``repro_torch.data.synthetic`` writes
    it): features uniform on [-1, 1]^d, column j scaled by the geometric
    spectrum 1 .. 1/cond; labels +-1 from a random ground-truth logistic
    model (w, b standard normal); rows optionally stored sorted by the true
    margin (the non-iid storage layout)."""
    n, d = int(cfg["n"]), int(cfg["d"])
    g = generator(seed, device)
    w = torch.randn(d, generator=g, device=device)
    b = torch.randn((), generator=g, device=device)
    scales = torch.logspace(0.0, -torch.log10(torch.tensor(
        max(float(cfg["cond"]), 1.0))).item(), d, dtype=torch.float64,
        device=device).to(torch.float32)
    x = torch.rand((n, d), generator=g, device=device)
    x.mul_(2.0).sub_(1.0).mul_(scales)
    margin = x @ w
    u = torch.rand(n, generator=g, device=device)
    y = torch.where(u < torch.sigmoid(margin + b), 1.0, -1.0)
    if cfg.get("sorted_layout", False):
        order = torch.argsort(margin, stable=True)
        x, y = x[order], y[order]
    return x, y


def program(core, cfg: dict):
    """The port's objective for this configuration."""
    return core.LogisticRegression(lam=float(cfg["lam"]))


def rows_per_sample(cfg: dict) -> int:
    """Rows of the Hessian's square root A a sample has."""
    return 1


def lam(cfg: dict) -> float:
    """The ridge term's weight: the Hessian's shift, and f's modulus of
    strong convexity."""
    return float(cfg["lam"])


def evaluate(cfg: dict, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """f and grad f at each row of w (C, d), float64, in blocks of rows."""
    n = x.shape[0]
    lam_ = lam(cfg)
    w = w.to(device=x.device, dtype=torch.float64)
    f = torch.zeros(w.shape[0], dtype=torch.float64, device=x.device)
    g = torch.zeros_like(w)
    for i in range(0, n, ROWS):
        xb = x[i:i + ROWS].double()
        yb = y[i:i + ROWS].double()[:, None]
        z = -yb * (xb @ w.T)                           # (rows, C)
        f += torch.logaddexp(z, torch.zeros((), dtype=z.dtype,
                                            device=z.device)).sum(0)
        g += (-yb * torch.sigmoid(z)).T @ xb
    return f / n + 0.5 * lam_ * (w * w).sum(1), g / n + lam_ * w


def coef(cfg: dict, xb: torch.Tensor, yb: torch.Tensor, w: torch.Tensor,
         n: int) -> torch.Tensor:
    """(rows, 1, 1): each sample's row of A, sqrt(s (1 - s) / n) x with
    s = sig(y x.w), in xb's dtype by the plain formulas."""
    # in float32 a row whose margin y x.w passes about 16.6 rounds its
    # sigmoid to 1 and drops out of A
    s = torch.sigmoid(yb * (xb @ w))
    return torch.sqrt(s * (1.0 - s) / n)[:, None, None]


class Problem:
    """f and its gradient as the control computes them: every product's
    operands through ``rnd``."""

    strongly_convex = True

    def __init__(self, cfg: dict, x, y, rnd):
        self.x, self.y, self.lam, self.rnd = rnd(x), y, lam(cfg), rnd
        self.n = x.shape[0]

    def value(self, w):                         # w (C, d) -> (C,)
        z = -self.y[:, None] * (self.x @ self.rnd(w).T)
        return (torch.logaddexp(z, torch.zeros_like(z)).mean(0)
                + 0.5 * self.lam * (w * w).sum(1))

    def gradient(self, w):
        z = -self.y * (self.x @ self.rnd(w))
        beta = -self.y * torch.sigmoid(z)
        return self.x.T @ self.rnd(beta) / self.n + self.lam * w


def iteration_flops(cfg: dict) -> float:
    """One Newton iteration's operations outside the sketch -> Gram call
    and the direction's solve, which the caller counts as they ran (the
    sketch's depend on the blocks that survived).  p = n d: the coded
    gradient's X w and X^T beta (4p); the Hessian square root's X w and row
    scaling (3p); the Armijo search's f at w and at every candidate
    (2p (1 + C)); the logged f and gradient at the new iterate (6p)."""
    return (4 + 3 + 2 * (1 + CANDIDATES) + 6) * float(cfg["n"]) * int(cfg["d"])
