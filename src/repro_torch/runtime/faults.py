"""The one piece of the reference's fault plane the port has yet:
``PhaseExhaustedError`` (``repro/runtime/faults.py``).  Fault plans wait
for ROADMAP Queue 1 item 6."""
from __future__ import annotations

import numpy as np


class PhaseExhaustedError(RuntimeError):
    """A phase's retry budget truly ran out (``fail_open=False``).

    Raised by ``FleetEngine.run_phase`` after billing every attempt and
    advancing the clock to the last observed lifecycle event.  ``mask`` is
    the boolean mask of workers whose results did land."""

    def __init__(self, phase: object, num_workers: int, mask: np.ndarray,
                 elapsed: float):
        self.phase = phase
        self.num_workers = int(num_workers)
        self.mask = np.asarray(mask, dtype=bool)
        self.elapsed = float(elapsed)
        lost = self.num_workers - int(self.mask.sum())
        super().__init__(
            f"phase {phase!r}: retry budget exhausted on {lost} of "
            f"{num_workers} workers")
