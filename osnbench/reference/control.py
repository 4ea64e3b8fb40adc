"""The plain reference solver, and the control that shows the comparison
can fail: OverSketched Newton in plain PyTorch, with a sketch of its own.

``Control`` stands where the program stands in ``run.run_cell``: called
with a start and a seed, it runs one call's worth of Newton iterations
and returns the last iterate with a per-iteration log (``fval``,
``gnorm``, ``step``, ``wall_s``), as a call of the program does.  Each
iteration takes the gradient, draws every sketch block of the cell's
family from its own generator (all live), forms the blocks' Gram
(``reference/sketch.py``), solves for the direction (Cholesky with the
regularizer, or the eigh pinv at PINV_RTOL) and takes the program's step
rule: the Armijo search on a strongly convex f, the gradient-norm search of
Eq. 6 on a weakly convex one, candidates 4^0 .. 4^-5, beta 0.1.  At the
iterations the run's audit draws, it hands the audit what the program's
path hands it: the iterate, the draws, the Gram, the gradient and the
direction.

Every matrix product takes its operands through ``rounding``: ``float32``
keeps them (a sound float32 solver, TF32 off); ``tf32`` rounds each
operand to TF32's 10-bit mantissa, to nearest, and accumulates in float32,
as the card's TF32 matrix units do.  In TF32 the solver is the control:
the configurations state float32 with TF32 off, and TF32 is the precision
below it.

This module imports nothing of the program under test.
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Callable, Dict

import torch

from osnbench.reference import sketch

CANDIDATES = tuple(4.0 ** (-i) for i in range(6))
BETA = 0.1
PINV_RTOL = 1e-6
CHOL_JITTER = 1e-9


def float32(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), kept in float32."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


ROUNDINGS: Dict[str, Callable] = {"float32": float32, "tf32": tf32}
FAMILIES = {"oversketch": "count", "srht": "srht"}   # traffic's name -> draw


def _first_ok(ok: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    idx = torch.argmax(ok.to(torch.int8))
    return torch.where(ok.any(), cand[idx], cand[-1])


class _Logistic:
    strongly_convex = True

    def __init__(self, x, y, lam, rnd):
        self.x, self.y, self.lam, self.rnd = rnd(x), y, lam, rnd
        self.n = x.shape[0]

    def value(self, w):                         # w (C, d) -> (C,)
        z = -self.y[:, None] * (self.x @ self.rnd(w).T)
        return (torch.logaddexp(z, torch.zeros_like(z)).mean(0)
                + 0.5 * self.lam * (w * w).sum(1))

    def gradient(self, w):
        z = -self.y * (self.x @ self.rnd(w))
        beta = -self.y * torch.sigmoid(z)
        return self.x.T @ self.rnd(beta) / self.n + self.lam * w

    def step(self, w, p, g, hg, cand):
        f0 = self.value(w[None])
        ft = self.value(w[None] + cand[:, None] * p[None])
        ok = (ft <= f0 + cand * BETA * (p @ g)) & torch.isfinite(ft)
        return _first_ok(ok, cand)


class _Softmax:
    strongly_convex = False
    lam = 0.0

    def __init__(self, x, y, classes, rnd):
        self.x, self.y, self.k, self.rnd = rnd(x), y, classes, rnd
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

    def step(self, w, p, g, hg, cand):
        trials = torch.stack([(gt * gt).sum() for gt in
                              (self.gradient(w + a * p) for a in cand)])
        ok = ((trials <= g @ g + 2.0 * cand * BETA * (p @ hg))
              & torch.isfinite(trials))
        return _first_ok(ok, cand)


def direction(h: torch.Tensor, g: torch.Tensor, solver: str) -> torch.Tensor:
    """-H^-1 g by Cholesky, or -H^+ g by the eigh pinv, in h's dtype."""
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    if solver == "chol":
        chol = torch.linalg.cholesky(h + CHOL_JITTER * eye)
        return -torch.cholesky_solve(g[:, None], chol)[:, 0]
    if solver == "pinv":
        evals, evecs = torch.linalg.eigh(h)
        cutoff = PINV_RTOL * evals.abs().max()
        inv = torch.where(evals.abs() > cutoff, 1.0 / evals,
                          torch.zeros_like(evals))
        return -(evecs @ (inv * (evecs.T @ g)))
    raise ValueError(f"no reference for solver {solver!r}")


def solver_of(cfg: dict, traffic: dict) -> str:
    solver = traffic["solver"]
    if solver == "auto":
        solver = "chol" if cfg["objective"] == "logistic" else "pinv"
    return solver


def total_blocks(traffic: dict) -> int:
    """N + e: the sketch's N = m / b blocks and the spare share zeta."""
    n_blocks = int(traffic["sketch_dim"]) // int(traffic["block_size"])
    return int(math.ceil(n_blocks * (1.0 + float(
        traffic["straggler_tolerance"]))))


class Control:
    """The reference solver in ``rounding``, in the program's place."""

    def __init__(self, cell: dict, x: torch.Tensor, y: torch.Tensor, device,
                 rounding: str = "tf32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.x, self.y, self.device = x, y, device
        self.rnd = ROUNDINGS[rounding]
        if self.cfg["objective"] == "logistic":
            self.prob = _Logistic(x, y, float(self.cfg["lam"]), self.rnd)
            self.dim = x.shape[1]
        elif self.cfg["objective"] == "softmax":
            k = int(self.cfg["classes"])
            self.prob = _Softmax(x, y, k, self.rnd)
            self.dim = x.shape[1] * k
        else:
            raise ValueError(
                f"no reference for objective {self.cfg['objective']!r}")
        self.solver = solver_of(self.cfg, self.tr)
        self.family = FAMILIES[self.tr["sketch_family"]]
        self.audit = None

    def attach_audit(self, audit) -> None:
        self.audit = audit

    def detach_audit(self, audit=None) -> None:
        self.audit = None

    def __call__(self, w0, seed: int, iters: int = 0):
        tr, prob, rnd = self.tr, self.prob, self.rnd
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        cand = torch.tensor(CANDIDATES, dtype=torch.float32,
                            device=self.device)
        w = w0.to(device=self.device, dtype=torch.float32).clone()
        hist = {k: [] for k in ("fval", "gnorm", "step", "wall_s")}
        n_rows = self.x.shape[0] * sketch.rows_per_sample(self.cfg)
        for _ in range(iters or int(tr["iters"])):
            t0 = time.perf_counter()
            armed = (self.audit is not None
                     and self.audit.next_iteration(w))
            g = prob.gradient(w)
            draws = sketch.draw(self.family, total_blocks(tr),
                                int(tr["block_size"]), n_rows, gen,
                                self.device)
            gram = sketch.gram(sketch.blocks(self.cfg, self.x, self.y, w,
                                             draws, torch.float32, rnd), rnd)
            h = gram + prob.lam * torch.eye(gram.shape[0], device=gram.device)
            p = direction(h, g, self.solver)
            if armed:
                self.audit.take(draws=draws, gram=gram, g=g, p=p)
            hg = rnd(h) @ rnd(g) if not prob.strongly_convex else None
            del gram
            step = prob.step(w, p, g, hg, cand)
            w = w + step * p
            hist["fval"].append(float(prob.value(w[None])[0]))
            hist["gnorm"].append(float(torch.linalg.vector_norm(
                prob.gradient(w))))
            hist["step"].append(float(step))
            hist["wall_s"].append(time.perf_counter() - t0)
        return SimpleNamespace(w=w, history=hist)
