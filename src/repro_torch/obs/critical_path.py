"""Critical-path + slack analytics over one dispatched phase DAG.

The scheduler records *when* every phase of a DAG iteration actually ran
(``DagResult``/``DagRun`` per-phase start/finish); this module answers the
operator questions those numbers exist for:

  - **Which chain of phases is binding the makespan?**  Shaving a second
    off any phase on the critical path shortens the iteration; shaving a
    phase off it does nothing.
  - **How much slack does every other phase have?**  Classic CPM backward
    pass over the recorded intervals: a phase's slack is how far its
    finish could slip (its duration grow) before it would extend the
    makespan — the headroom the scheduler's pool-aware dispatch and the
    launch planner's per-phase sizing get to spend for free.

Inputs are plain ``{name: (start, finish, deps)}`` mappings so the module
depends on nothing else in the repo; ``from_dag(...)`` adapts a
``DagResult`` or ``DagRun`` (both expose ``.results`` / ``.start``), and
phase spans recorded with a ``deps`` attribute adapt through
``from_spans``-style dicts in ``obs.export``.

Chain identification walks backward from the phase that finishes last:
the binding predecessor of a phase is the dependency whose finish equals
the phase's start (the engine launches at ``max(dag_start, max dep
finish)``, so the equality is exact, not approximate); ties break
lexicographically so the report is deterministic.  A phase whose start
exceeds every dependency's finish was floored by something outside the
DAG (the dag start itself, or an explicit ``min_start``) — the chain
roots there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

#: Input row: (start, finish, deps) — absolute simulated seconds + names.
PhaseTimes = Tuple[float, float, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class PhaseSlack:
    """One phase's placement plus its CPM slack."""

    name: str
    start: float
    finish: float
    slack: float                  # seconds of headroom; 0 on the chain
    on_critical_path: bool
    deps: Tuple[str, ...]

    @property
    def duration(self) -> float:
        return self.finish - self.start


@dataclasses.dataclass(frozen=True)
class CriticalPathReport:
    """Makespan decomposition of one dispatched DAG."""

    start: float                          # DAG launch time
    makespan: float                       # last finish - start
    critical_path: Tuple[str, ...]        # binding chain, execution order
    phases: Dict[str, PhaseSlack]         # every phase, keyed by name

    @property
    def critical_seconds(self) -> float:
        """Sum of critical-phase durations (= makespan minus any float-in
        gap before the chain roots at the DAG start)."""
        return sum(self.phases[n].duration for n in self.critical_path)

    def rows(self) -> List[dict]:
        """Table-ready rows, critical chain first then by start time."""
        order = sorted(
            self.phases.values(),
            key=lambda p: (not p.on_critical_path, p.start, p.name))
        return [{"phase": p.name, "start": p.start, "finish": p.finish,
                 "duration": p.duration, "slack": p.slack,
                 "critical": p.on_critical_path} for p in order]


def critical_path(phases: Mapping[str, PhaseTimes],
                  start: Optional[float] = None) -> CriticalPathReport:
    """CPM analysis of recorded phase intervals.

    ``phases`` maps each phase name to its recorded ``(start, finish,
    deps)``; ``start`` is the DAG launch time (defaults to the earliest
    recorded start).  Durations are taken as recorded — this is analysis
    of what *did* happen, not a what-if simulator.
    """
    if not phases:
        raise ValueError("critical_path needs at least one phase")
    norm: Dict[str, Tuple[float, float, Tuple[str, ...]]] = {}
    for name, (s, f, deps) in phases.items():
        deps = tuple(deps)
        for d in deps:
            if d not in phases:
                raise ValueError(
                    f"phase {name!r} depends on unknown phase {d!r}")
        if f < s:
            raise ValueError(
                f"phase {name!r} finishes ({f}) before it starts ({s})")
        norm[name] = (float(s), float(f), deps)
    t0 = min(s for s, _, _ in norm.values()) if start is None else float(start)
    end = max(f for _, f, _ in norm.values())

    # Backward pass: latest finish each phase could have without moving
    # the makespan, given every successor's recorded start-to-finish span.
    children: Dict[str, List[str]] = {n: [] for n in norm}
    for name, (_, _, deps) in norm.items():
        for d in deps:
            children[d].append(name)
    latest_finish: Dict[str, float] = {}

    def lf(name: str) -> float:
        if name in latest_finish:
            return latest_finish[name]
        kids = children[name]
        if not kids:
            out = end
        else:
            # A child could start as late as lf(child) - duration(child);
            # this phase must finish by the earliest such latest-start.
            out = min(lf(c) - (norm[c][1] - norm[c][0]) for c in kids)
        latest_finish[name] = out
        return out

    for name in norm:
        lf(name)

    # Binding chain: walk back from the (lexicographically first) phase
    # that finishes last, following the dependency whose finish equals the
    # current phase's launch time.
    tail = min(n for n, (_, f, _) in norm.items() if f == end)
    chain = [tail]
    while True:
        s, _, deps = norm[chain[-1]]
        binding = sorted(d for d in deps if norm[d][1] == s)
        if not binding:
            break          # floored by the DAG start or a min_start
        chain.append(binding[0])
    chain.reverse()
    on_chain = set(chain)

    out: Dict[str, PhaseSlack] = {}
    for name, (s, f, deps) in norm.items():
        slack = latest_finish[name] - f
        # Float roundoff guard: a chain member's slack is 0 by definition.
        if name in on_chain:
            slack = 0.0
        out[name] = PhaseSlack(name=name, start=s, finish=f,
                               slack=max(0.0, slack),
                               on_critical_path=name in on_chain, deps=deps)
    return CriticalPathReport(start=t0, makespan=end - t0,
                              critical_path=tuple(chain), phases=out)


def from_dag(dag) -> CriticalPathReport:
    """Adapt a ``scheduler.DagResult`` or ``DagRun`` (anything exposing
    ``.results`` name->PhaseResult and ``.start``)."""
    return critical_path(
        {name: (r.start, r.finish, r.spec.deps)
         for name, r in dag.results.items()},
        start=dag.start)
