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
  sketch_gram  each sketch family's fused kernel (``families/<family>.py``:
               ``ENTRY`` in ``kernels.ops``)
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

from osnbench import spec

PREFIX = "osnbench."


class Recorder:
    """What the wrappers saw during one traced window."""

    def __init__(self):
        self.sketch_gram: List[tuple] = []    # (family, sizes, mask)
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

        def counter(fam):
            def count(*args, **kwargs):
                draws, a = fam.unpack(*args, **kwargs)
                self.sketch_gram.append((fam, fam.sizes(draws, a),
                                         draws["live"].clone()))
            return count

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
        for fam in spec.families():
            self._patch(kops, fam.ENTRY, "sketch_gram", counter(fam))
        self._patch(kops, "coded_block_matvec", "coded_matvec", count_coded)
        self._patch(straggler.SimClock, "phase", "fleet")
        self._patch(dag.DagRun, "dispatch", "fleet")
        return self

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def sketch_calls(self) -> List[tuple]:
        """(family's LABEL, k, n, d, b, live blocks) of each sketch -> Gram
        call."""
        return [(fam.LABEL, z["k"], z["n"], z["d"], z["b"], live)
                for fam, z, live in self.family_calls()]

    def family_calls(self) -> List[tuple]:
        """(family, sizes, live blocks) of each sketch -> Gram call: the
        family's module and its ``sizes`` of the call, which its ``flops``
        and ``bound_s`` take with the live blocks."""
        return [(fam, sizes, int(m.sum())) for fam, sizes, m
                in self.sketch_gram]

    def coded_calls(self) -> List[tuple]:
        """(workers, b, s, live workers) of each coded mat-vec launch."""
        return [(w, b, s, int(w - e.sum())) for w, b, s, e in self.coded]
