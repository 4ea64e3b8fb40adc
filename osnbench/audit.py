"""What the timed path computed inside the window, at iterations drawn from
the seed, kept on the host for the judge: the iterate, the sketch's draws
and live blocks, the Gram the fused kernel returned, the gradient the
direction was solved with, and the direction.

The plan names a call of the window and an iteration in it; call 0 is
always audited, and one later call when the window reaches it.  Capturing
copies the draws to the host in small pieces (one byte an entry), so the
device's peak does not move; the judge (``reference/judge.py``) works the
same quantities out again in float64 after the window.

On the program's path the audit wraps the entries that the main loop
calls each iteration: ``core.newton._hessian_phase`` (it opens the
iteration and reads the iterate), the cell's sketch family's fused kernel
(``families/<family>.py``: ``ENTRY`` in ``kernels.ops``; the draws as the
kernel received them and its output), and ``core.newton._solve_direction``
(the gradient and the direction).  A stand-in solver
(``reference/control.py``) calls ``next_iteration`` and ``take`` itself.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from osnbench.datagen import derive

PIECE = 16          # rows of a draw copied to the host at a time


def plan(seed: int, traffic: dict) -> Dict[int, int]:
    """{call: iteration}: call 0 and one of calls 1 .. audit_calls - 1,
    each at an iteration drawn from the seed."""
    iters = int(traffic["iters"])
    later = 1 + derive(seed, "audit", "call") % max(
        1, int(traffic["audit_calls"]) - 1)
    return {c: derive(seed, "audit", c) % iters for c in (0, later)}


def host(t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host copy, converted ``PIECE`` rows at a time."""
    if dtype is None:
        return t.detach().to("cpu", copy=True)
    return torch.cat([t[i:i + PIECE].to(dtype).cpu()
                      for i in range(0, t.shape[0], PIECE)])


def compact_codes(h: torch.Tensor, block_size: int) -> Dict:
    """Bucket codes in [0, block_size) on the host as small integers, with
    their range (a code outside it stays visible there)."""
    dtype = torch.uint8 if block_size <= 256 else torch.int32
    return {"h": host(h, dtype), "h_range": (int(h.min()), int(h.max()))}


def compact_draws(draws: Dict, family) -> Dict:
    """The draws on the host: signs as int8 (a sign that is not +-1 stays
    visible as another value), the live blocks, and what ``family``'s
    ``compact`` keeps of its own draws."""
    out = {"block_size": int(draws["block_size"]),
           "live": host(draws["live"]).bool(),
           "sigma": host(draws["sigma"], torch.int8),
           "sigma_abs": (float(draws["sigma"].abs().min()),
                         float(draws["sigma"].abs().max()))}
    out.update(family.compact(draws))
    return out


class Audit:
    """The audited iterations of a window whose sketch is ``family``'s."""

    def __init__(self, plan_: Dict[int, int], family):
        self.plan = dict(plan_)
        self.family = family
        self.records: List[Dict] = []
        self.call: Optional[int] = None
        self.iteration = -1
        self.current: Optional[Dict] = None
        self._undo: List[Callable] = []

    def begin_call(self, i: int) -> None:
        self.call, self.iteration, self.current = i, -1, None

    def end_window(self) -> None:
        self.call, self.current = None, None

    def next_iteration(self, w: torch.Tensor) -> bool:
        """Opens the next iteration of the call; True where it is audited."""
        self.iteration += 1
        self.current = None
        if self.call is not None and self.plan.get(self.call) == self.iteration:
            self.current = {"call": self.call, "iteration": self.iteration,
                            "w": host(w)}
            self.records.append(self.current)
        return self.current is not None

    def take(self, draws: Optional[Dict] = None, **tensors) -> None:
        """Keeps the audited iteration's tensors (the first of each)."""
        if self.current is None:
            return
        if draws is not None and "draws" not in self.current:
            self.current["draws"] = compact_draws(draws, self.family)
        for k, v in tensors.items():
            self.current.setdefault(k, host(v))

    # --- the program's path -------------------------------------------
    def _wrap(self, owner, attr: str, make: Callable) -> None:
        orig = getattr(owner, attr)
        setattr(owner, attr, functools.wraps(orig)(make(orig)))
        self._undo.append(lambda: setattr(owner, attr, orig))

    def install(self) -> "Audit":
        from repro_torch.core import newton
        from repro_torch.kernels import ops as kops

        def hessian(orig):
            def f(objective, data, w, *args, **kwargs):
                self.next_iteration(w)
                return orig(objective, data, w, *args, **kwargs)
            return f

        def sketch_gram(orig):
            def f(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.current is not None:
                    draws, _ = self.family.unpack(*args, **kwargs)
                    self.take(draws=draws, gram=out)
                return out
            return f

        def direction(orig):
            def f(objective, h_hat, g, cfg):
                p = orig(objective, h_hat, g, cfg)
                self.take(g=g, p=p)
                return p
            return f

        self._wrap(newton, "_hessian_phase", hessian)
        self._wrap(kops, self.family.ENTRY, sketch_gram)
        self._wrap(newton, "_solve_direction", direction)
        return self

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()
