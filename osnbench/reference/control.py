"""The plain reference solver, and the control that shows the comparison
can fail: OverSketched Newton in plain PyTorch, with a sketch of its own.

``Control`` stands where the program stands in ``run.run_cell``: called
with a start and a seed, it runs one call's worth of Newton iterations
and returns the last iterate with a per-iteration log (``fval``,
``gnorm``, ``step``, ``wall_s``), as a call of the program does.  Each
iteration takes the gradient (the objective's ``Problem``), draws every
sketch block of the cell's family from its own generator (the family's
``draw``, all live), forms the blocks' Gram (``reference/sketch.py``),
solves for the direction (Cholesky with the regularizer, or the eigh pinv
at PINV_RTOL) and takes the program's step rule: the Armijo search on a
strongly convex f, the gradient-norm search of Eq. 6 on a weakly convex
one, candidates 4^0 .. 4^-5, beta 0.1.  At the iterations the run's audit
draws, it hands the audit what the program's path hands it: the iterate,
the draws, the Gram, the gradient and the direction.

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


def _first_ok(ok: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    idx = torch.argmax(ok.to(torch.int8))
    return torch.where(ok.any(), cand[idx], cand[-1])


def armijo(prob, w, p, g, hg, cand):
    """The first candidate with f(w + a p) <= f(w) + a beta p.g (Eq. 5)."""
    f0 = prob.value(w[None])
    ft = prob.value(w[None] + cand[:, None] * p[None])
    ok = (ft <= f0 + cand * BETA * (p @ g)) & torch.isfinite(ft)
    return _first_ok(ok, cand)


def gradient_norm(prob, w, p, g, hg, cand):
    """The first candidate with ||grad f(w + a p)||^2 <= ||g||^2 +
    2 a beta p.Hg (Eq. 6)."""
    trials = torch.stack([(gt * gt).sum() for gt in
                          (prob.gradient(w + a * p) for a in cand)])
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


def solver_of(objective, traffic: dict) -> str:
    """The traffic's solver, ``auto`` resolved as the objective says."""
    solver = traffic["solver"]
    return objective.AUTO_SOLVER if solver == "auto" else solver


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
        self.cell, obj = cell, cell["objective"]
        self.prob = obj.Problem(self.cfg, x, y, self.rnd)
        self.rows = obj.rows_per_sample(self.cfg)
        self.dim = x.shape[1] * self.rows
        self.solver = solver_of(obj, self.tr)
        self.step_rule = armijo if self.prob.strongly_convex \
            else gradient_norm
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
        n_rows = self.x.shape[0] * self.rows
        for _ in range(iters or int(tr["iters"])):
            t0 = time.perf_counter()
            armed = (self.audit is not None
                     and self.audit.next_iteration(w))
            g = prob.gradient(w)
            draws = self.cell["family"].draw(total_blocks(tr),
                                             int(tr["block_size"]), n_rows,
                                             gen, self.device)
            gram = sketch.gram(sketch.blocks(self.cell, self.x, self.y, w,
                                             draws, torch.float32, rnd), rnd)
            h = gram + prob.lam * torch.eye(gram.shape[0], device=gram.device)
            p = direction(h, g, self.solver)
            if armed:
                self.audit.take(draws=draws, gram=gram, g=g, p=p)
            hg = rnd(h) @ rnd(g) if not prob.strongly_convex else None
            del gram
            step = self.step_rule(prob, w, p, g, hg, cand)
            w = w + step * p
            hist["fval"].append(float(prob.value(w[None])[0]))
            hist["gnorm"].append(float(torch.linalg.vector_norm(
                prob.gradient(w))))
            hist["step"].append(float(step))
            hist["wall_s"].append(time.perf_counter() - t0)
        return SimpleNamespace(w=w, history=hist)
