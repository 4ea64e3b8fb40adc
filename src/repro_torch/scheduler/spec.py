"""Phase specifications and DAG validation for the phase-DAG scheduler;
port of ``repro/scheduler/spec.py``.

Dispatch order is canonical (``canonical_order``): Kahn's algorithm with
the ready set popped in lexicographic name order, so two declarations of
one DAG in different topological orders dispatch, bill and draw alike.
Per-phase keys fold a stable CRC-32 of the phase name into the run key
(``key_fold``): Python's salted ``hash`` would break cross-process
reproducibility.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, List, Optional, Sequence, Tuple


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
    # True per-worker working set in GB: an attached fault plan's OomSpec
    # kills attempts billed below it.
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


def validate_dag(specs: Sequence[PhaseSpec]) -> None:
    """Raise ValueError on duplicate names, unknown deps, or cycles."""
    canonical_order(specs)


def canonical_order(specs: Sequence[PhaseSpec]) -> List[PhaseSpec]:
    """Kahn's topological sort, ready set in lexicographic name order.

    The canonical order is a pure function of the DAG (names + edges):
    permuting the declaration order never changes the dispatch order.
    Validates as it sorts: duplicate names, unknown deps, and cycles all
    raise ValueError.
    """
    seen = set()
    for s in specs:
        if s.name in seen:
            raise ValueError(f"duplicate phase name {s.name!r}")
        seen.add(s.name)
    for s in specs:
        for d in s.deps:
            if d not in seen:
                raise ValueError(
                    f"phase {s.name!r} depends on unknown phase {d!r}")
    by_name = {s.name: s for s in specs}
    indeg = {s.name: len(set(s.deps)) for s in specs}
    children: dict = {s.name: [] for s in specs}
    for s in specs:
        for d in set(s.deps):
            children[d].append(s.name)
    ready = sorted(n for n, deg in indeg.items() if deg == 0)
    order: List[PhaseSpec] = []
    while ready:
        n = ready.pop(0)
        order.append(by_name[n])
        grew = False
        for c in children[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
                grew = True
        if grew:
            ready.sort()
    if len(order) != len(specs):
        stuck = sorted(n for n, deg in indeg.items() if deg > 0)
        raise ValueError(f"phase DAG has a cycle through {stuck}")
    return order
