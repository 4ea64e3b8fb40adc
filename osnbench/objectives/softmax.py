"""Softmax (multinomial logistic) regression, unregularized
(arXiv:1903.08857 Sec. 4.2, Fig. 9): f(W) = mean (logsumexp(x W^T) -
y . x W^T) over n rows x of d features and one-hot labels y of K classes,
W flattened class-major to K d entries.  Its configuration gives n, d and
classes.  Weakly convex: the port's ``auto`` solver is the eigh pinv and
its line search the gradient-norm search of Eq. 6.

What the harness asks of an objective is listed in ``osnbench/README.md``.
This module imports nothing of the program: ``program`` is handed the
port's ``core``.
"""
from __future__ import annotations

import math

import torch

from osnbench.counts import CANDIDATES
from osnbench.datagen import ROWS, generator

AUTO_SOLVER = "pinv"


def generate(cfg: dict, seed: int, device):
    """(x (n, d) float32, y (n, K) float32 one-hot): standard normal
    features; labels drawn from the categorical distributions
    softmax(x W^T) of a random (K, d) model (Gumbel-max)."""
    n, d, k = int(cfg["n"]), int(cfg["d"]), int(cfg["classes"])
    g = generator(seed, device)
    w = torch.randn((k, d), generator=g, device=device)
    x = torch.randn((n, d), generator=g, device=device)
    u = torch.rand((n, k), generator=g, device=device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min_(tiny)))
    labels = torch.argmax(x @ w.T + gumbel, dim=1)
    y = torch.nn.functional.one_hot(labels, k).to(torch.float32)
    return x, y


def program(core, cfg: dict):
    """The port's objective for this configuration."""
    return core.SoftmaxRegression(num_classes=int(cfg["classes"]))


def rows_per_sample(cfg: dict) -> int:
    """Rows of the Hessian's square root A a sample has: one a class."""
    return int(cfg["classes"])


def lam(cfg: dict) -> float:
    """No ridge term: the Hessian is not shifted."""
    return 0.0


def evaluate(cfg: dict, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """f and grad f at each row of w (C, K d), class-major, float64, in
    blocks of rows."""
    classes = int(cfg["classes"])
    n, d = x.shape
    c = w.shape[0]
    w = w.to(device=x.device, dtype=torch.float64)
    wk = w.reshape(c * classes, d)
    f = torch.zeros(c, dtype=torch.float64, device=x.device)
    g = torch.zeros_like(wk)
    for i in range(0, n, ROWS):
        xb = x[i:i + ROWS].double()
        yb = y[i:i + ROWS].double()[:, None, :]
        logits = (xb @ wk.T).view(-1, c, classes)      # (rows, C, K)
        f += (torch.logsumexp(logits, -1) - (logits * yb).sum(-1)).sum(0)
        resid = torch.softmax(logits, -1) - yb
        g += resid.reshape(-1, c * classes).T @ xb
    return f / n, g.reshape(c, classes * d) / n


def coef(cfg: dict, xb: torch.Tensor, yb: torch.Tensor, w: torch.Tensor,
         n: int) -> torch.Tensor:
    """(rows, K, K): coef[s, c, i], sample s's row c of A on class i's
    columns, at the iterate w, in xb's dtype by the plain formulas."""
    k = int(cfg["classes"])
    p = torch.softmax(xb @ w.reshape(k, xb.shape[1]).T, -1)   # (rows, K)
    eye = torch.eye(k, dtype=p.dtype, device=p.device)
    # M[i, c] = sqrt(p_c) (delta_ic - p_i), so M M^T = diag(p) - p p^T
    m = torch.sqrt(p)[:, None, :] * (eye[None] - p[:, :, None])
    return m.transpose(1, 2) / math.sqrt(n)


class Problem:
    """f and its gradient as the control computes them: every product's
    operands through ``rnd``."""

    strongly_convex = False
    lam = 0.0

    def __init__(self, cfg: dict, x, y, rnd):
        self.x, self.y, self.k, self.rnd = rnd(x), y, int(cfg["classes"]), rnd
        self.n, self.d = x.shape

    def _logits(self, w):                       # w (C, K d) -> (n, C, K)
        c = w.shape[0]
        wk = self.rnd(w).reshape(c * self.k, self.d)
        return (self.x @ wk.T).view(self.n, c, self.k)

    def value(self, w):
        lg = self._logits(w)
        return (torch.logsumexp(lg, -1)
                - (lg * self.y[:, None, :]).sum(-1)).mean(0)

    def gradient(self, w):
        p = torch.softmax(self._logits(w[None])[:, 0], -1)
        return (self.x.T @ self.rnd(p - self.y)).T.reshape(-1) / self.n


def iteration_flops(cfg: dict) -> float:
    """One Newton iteration's operations outside the sketch -> Gram call
    and the direction's solve, which the caller counts as they ran.
    p = n d K, D = d K: the gradient's K mat-vecs each way (4p); the square
    root's logits (2p) and its (n K, D) product, one multiply and one
    divide an element (2 n K D); the gradient-norm search's trial gradients
    (4p C) and the sketched Hessian times g (2 D^2); the logged f and
    gradient (6p)."""
    n, d, classes = int(cfg["n"]), int(cfg["d"]), int(cfg["classes"])
    p = float(n) * d * classes
    dim = d * classes
    return ((4 + 2 + 4 * CANDIDATES + 6) * p + 2.0 * n * classes * dim
            + 2.0 * dim * dim)
