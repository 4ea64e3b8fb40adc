"""Spans and counters around the calls into each layer of the program,
from the benchmark's side: installed only for a traced run, removed after.

Each wrapped call runs inside a ``torch.profiler.record_function`` range
named ``osnbench.<layer>``, so the profiler's trace ties every device
operation to the layer whose call launched it.  The wrappers also count
what the count functions need (the sketch blocks that survived, the coded
blocks that arrived, the solves), keeping the small masks on the device
until the window has closed.

  encode       ``core.newton.CodedMatvecEngine.__init__`` (each call's
               product-code encodes of X and X^T)
  gradient     ``CodedMatvecEngine.matvec`` (the coded gradient)
  hessian      ``core.newton._hessian_phase`` (A, the sketch, its Gram)
  sketch_gram  ``kernels.ops.sketch_gram_count`` / ``sketch_gram_srht``
  coded_matvec ``kernels.ops.coded_block_matvec``
  direction    ``core.newton._solve_direction``
  linesearch   ``core.linesearch.linesearch_strongly_convex`` /
               ``linesearch_weakly_convex``
  fleet        ``core.straggler.SimClock.phase``, ``scheduler.DagRun.dispatch``
               (the simulated fleet, host work only: it names idle gaps)
"""
from __future__ import annotations

import functools
from typing import Callable, List

import torch

PREFIX = "osnbench."


class Recorder:
    """What the wrappers saw during one traced window."""

    def __init__(self):
        self.sketch_gram: List[tuple] = []    # (family, k, n, d, b, mask)
        self.coded: List[tuple] = []          # (workers, b, s, erased)
        self.solves: List[tuple] = []         # (solver, dim)
        self._undo: List[Callable] = []

    def _patch(self, owner, attr: str, layer: str, count=None) -> None:
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if count is not None:
                count(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + layer):
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def install(self) -> "Recorder":
        from repro_torch.core import linesearch, newton, straggler
        from repro_torch.kernels import ops as kops
        from repro_torch.scheduler import dag

        def count_sgc(h, sigma, a, block_size, survivors):
            self.sketch_gram.append(("count", h.shape[0], a.shape[0],
                                     a.shape[1], int(block_size),
                                     survivors.clone()))

        def count_srht(rows, sigma, a, survivors):
            self.sketch_gram.append(("srht", rows.shape[0], a.shape[0],
                                     a.shape[1], rows.shape[1],
                                     survivors.clone()))

        def count_coded(enc, x, erased):
            w, b, s = enc.shape
            self.coded.append((w, b, s, erased.clone()))

        def count_solve(objective, h_hat, g, cfg):
            solver = cfg.solver
            if solver == "auto":
                solver = "chol" if objective.strongly_convex else "pinv"
            self.solves.append((solver, h_hat.shape[0]))

        self._patch(newton.CodedMatvecEngine, "__init__", "encode")
        self._patch(newton.CodedMatvecEngine, "matvec", "gradient")
        self._patch(newton, "_hessian_phase", "hessian")
        self._patch(newton, "_solve_direction", "direction", count_solve)
        self._patch(linesearch, "linesearch_strongly_convex", "linesearch")
        self._patch(linesearch, "linesearch_weakly_convex", "linesearch")
        self._patch(kops, "sketch_gram_count", "sketch_gram", count_sgc)
        self._patch(kops, "sketch_gram_srht", "sketch_gram", count_srht)
        self._patch(kops, "coded_block_matvec", "coded_matvec", count_coded)
        self._patch(straggler.SimClock, "phase", "fleet")
        self._patch(dag.DagRun, "dispatch", "fleet")
        return self

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def sketch_calls(self) -> List[tuple]:
        """(family, k, n, d, b, live blocks) of each sketch -> Gram call."""
        return [(f, k, n, d, b, int(m.sum())) for f, k, n, d, b, m
                in self.sketch_gram]

    def coded_calls(self) -> List[tuple]:
        """(workers, b, s, live workers) of each coded mat-vec launch."""
        return [(w, b, s, int(w - e.sum())) for w, b, s, e in self.coded]
