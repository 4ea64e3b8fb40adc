"""Phase specifications for the phase-DAG scheduler; port of
``repro/scheduler/spec.py`` (``PhaseSpec``).

Per-phase keys fold a stable CRC-32 of the phase name into the run key
(``key_fold``): Python's salted ``hash`` would break cross-process
reproducibility.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One declared distributed phase of an iteration DAG."""

    name: str
    workers: int
    policy: str = "wait_all"
    k: Optional[int] = None
    work_per_worker: float = 1.0
    flops_per_worker: Optional[float] = None
    comm_units: float = 0.0
    # Declared per-worker Lambda size for billing (None: fleet default).
    memory_gb: Optional[float] = None
    # True per-worker working set in GB (read by the reference's fault plane).
    working_set_gb: Optional[float] = None
    deps: Tuple[str, ...] = ()
    decodable: Optional[Callable] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("phase needs a non-empty name")
        if self.workers < 1:
            raise ValueError(f"phase {self.name!r}: workers must be >= 1")
        if self.memory_gb is not None and self.memory_gb <= 0:
            raise ValueError(f"phase {self.name!r}: memory_gb must be > 0")
        if self.working_set_gb is not None and self.working_set_gb <= 0:
            raise ValueError(
                f"phase {self.name!r}: working_set_gb must be > 0")
        object.__setattr__(self, "deps", tuple(self.deps))

    @property
    def key_fold(self) -> int:
        """Stable per-name fold constant for the run's PRNG key."""
        return zlib.crc32(self.name.encode("utf-8")) & 0x7FFFFFFF
