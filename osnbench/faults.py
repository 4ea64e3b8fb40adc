"""Faults planted in the timed path underneath a run, to show that the
comparison that decides ``correct`` catches each one: the CPU tests run
every fault through ``run.run_cell`` at a small size, and
``python -m osnbench.calibrate --side fault:<name>`` reads it on the card
at the cell's own size.  Each fault patches the port's module attributes
and ``plant`` undoes it on exit.  The Gram's faults patch the cell's sketch
family's fused kernel (``families/<family>.py``: ``ENTRY``).

  state_unchanged  the line search returns step 0: every call returns its
                   start
  half_batch       the solver sees the first half of the rows, the means
                   taken over them
  answer_altered   the returned iterate moved by 1e-3 of its largest entry
  half_blocks      the sketch -> Gram kernel drops every other live block
                   (a thinner sketch, averaged over the blocks it kept)
  hessian_x2       the sketch -> Gram kernel's output doubled
  tf32_gram        the sketch -> Gram kernel reads A rounded to TF32
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import torch

from osnbench.reference.control import tf32


def _step_zero(objective, data, w, *args, **kwargs):
    return torch.zeros((), dtype=w.dtype, device=w.device)


def _half_batch(orig):
    def solve(objective, data, w0, cfg, **kw):
        n = data.x.shape[0] // 2
        return orig(objective, type(data)(x=data.x[:n], y=data.y[:n]), w0,
                    cfg, **kw)
    return solve


def _altered(orig):
    def solve(*args, **kw):
        res = orig(*args, **kw)
        res.w[0] += 1e-3 * float(res.w.abs().max())
        return res
    return solve


def _tf32_in_place(a: torch.Tensor) -> torch.Tensor:
    """A rounded to TF32 where it lies, a block of rows at a time (the
    Hessian's square root is the phase's own scratch, made anew each
    iteration, and at softmax's size it fills most of the card)."""
    rows = max(1, (1 << 28) // max(1, a[0].numel()))
    for i in range(0, a.shape[0], rows):
        a[i:i + rows] = tf32(a[i:i + rows])
    return a


def _half_live(survivors: torch.Tensor) -> torch.Tensor:
    live = torch.nonzero(survivors).flatten()
    out = survivors.clone()
    out[live[1::2]] = False
    return out


def _gram(change: Callable, family) -> Callable:
    """Wraps ``family``'s sketch -> Gram entry with ``change(a, mask,
    call)``, where ``call(a, mask)`` runs the original."""
    def make(orig):
        def f(*args, **kwargs):
            draws, a = family.unpack(*args, **kwargs)
            return change(a, draws["live"], lambda a2, m2: orig(
                *family.pack(dict(draws, live=m2), a2)))
        return f
    return make


GRAM_FAULTS = {
    "half_blocks": lambda a, m, call: call(a, _half_live(m)),
    "hessian_x2": lambda a, m, call: 2.0 * call(a, m),
    "tf32_gram": lambda a, m, call: call(_tf32_in_place(a), m),
}
FAULTS = ("state_unchanged", "half_batch", "answer_altered") \
    + tuple(GRAM_FAULTS)


def _patches(name: str, family) -> List[Tuple[object, str, Callable]]:
    from osnbench.run import program
    program()                       # the port's package on the path
    from repro_torch import core
    from repro_torch.core import linesearch
    from repro_torch.kernels import ops as kops
    if name == "state_unchanged":
        return [(linesearch, "linesearch_strongly_convex",
                 lambda orig: _step_zero),
                (linesearch, "linesearch_weakly_convex",
                 lambda orig: _step_zero)]
    if name == "half_batch":
        return [(core, "oversketched_newton", _half_batch)]
    if name == "answer_altered":
        return [(core, "oversketched_newton", _altered)]
    if name in GRAM_FAULTS:
        return [(kops, family.ENTRY, _gram(GRAM_FAULTS[name], family))]
    raise KeyError(f"no fault {name!r}; faults: {', '.join(FAULTS)}")


@contextlib.contextmanager
def plant(name: str, family):
    """The fault ``name`` in place for the body of the ``with``, in a cell
    whose sketch is ``family``'s."""
    undo: Dict[Tuple[int, str], Tuple[object, str, object]] = {}
    try:
        for owner, attr, make in _patches(name, family):
            orig = getattr(owner, attr)
            undo[(id(owner), attr)] = (owner, attr, orig)
            setattr(owner, attr, make(orig))
        yield
    finally:
        for owner, attr, orig in undo.values():
            setattr(owner, attr, orig)
