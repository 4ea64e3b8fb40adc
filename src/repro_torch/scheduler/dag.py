"""Phase-DAG dispatch on top of ``FleetEngine.run_phase(not_before=...)``;
port of ``repro/scheduler/dag.py`` (``DagRun``, ``DagResult``,
``run_dag``).

An optimizer dispatches one iteration's phases with dependency edges; each
phase launches at

    launch(p) = max(dag_start, max over deps d of finish(d))

so phases with no path between them (the gradient round and the Hessian
sketch) overlap on the simulated timeline.  A phase whose launch time
equals the current clock takes the engine's sequential path, so a DAG that
serializes every phase reproduces the sequential schedule bit for bit.
``run_dag`` validates a declared DAG and dispatches it in the canonical
order (``spec.canonical_order``).

The reference's ``critical_path`` methods (``DagRun`` and ``DagResult``)
read its ``obs`` package and wait for ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import prng
from repro_torch.scheduler.spec import PhaseSpec, canonical_order


@dataclasses.dataclass
class PhaseResult:
    """One dispatched phase on the absolute simulated timeline."""

    spec: PhaseSpec
    start: float
    elapsed: float
    finish: float
    mask: torch.Tensor


@dataclasses.dataclass
class DagResult:
    """What ``run_dag`` hands back."""

    order: List[str]                      # canonical dispatch order
    results: Dict[str, PhaseResult]
    start: float
    makespan: float                       # max finish - start

    def finish(self, name: str) -> float:
        return self.results[name].finish


class DagRun:
    """Imperative phase-DAG dispatch against one ``SimClock``; ``key`` seeds
    the keys of phases dispatched without one."""

    def __init__(self, clock, key: Optional[torch.Tensor] = None,
                 start: Optional[float] = None):
        self.clock = clock
        self.key = key
        self.start = float(clock.time if start is None else start)
        self.results: Dict[str, PhaseResult] = {}
        self.last: Optional[str] = None   # most recently dispatched name

    def launch_time(self, spec: PhaseSpec) -> float:
        missing = [d for d in spec.deps if d not in self.results]
        if missing:
            raise ValueError(
                f"phase {spec.name!r} depends on undispatched {missing}")
        return max([self.start]
                   + [self.results[d].finish for d in spec.deps])

    def dispatch(self, spec: PhaseSpec, key: Optional[torch.Tensor] = None,
                 sequential: bool = False,
                 min_start: Optional[float] = None) -> PhaseResult:
        """Simulate one phase at its DAG launch time.  ``sequential``
        launches at the current clock (the barrier baseline); ``min_start``
        floors the launch time at work done outside the DAG."""
        if spec.name in self.results:
            raise ValueError(f"phase {spec.name!r} already dispatched")
        if key is None:
            if self.key is None:
                raise ValueError(
                    f"phase {spec.name!r}: DagRun has no base key; pass one "
                    "to DagRun(...) or dispatch(..., key=...)")
            key = prng.fold_in(self.key, spec.key_fold)
        now = float(self.clock.time)
        nb = now if sequential else self.launch_time(spec)
        if min_start is not None:
            nb = max(nb, float(min_start))
        elapsed, mask = self.clock.phase(
            key, spec.workers, policy=spec.policy, k=spec.k,
            work_per_worker=spec.work_per_worker,
            flops_per_worker=spec.flops_per_worker,
            comm_units=spec.comm_units, decodable=spec.decodable,
            not_before=None if nb == now else nb,
            memory_gb=spec.memory_gb,
            working_set_gb=spec.working_set_gb,
            phase_name=spec.name, phase_deps=spec.deps)
        finish = float(self.clock.time) if nb == now else nb + elapsed
        res = PhaseResult(spec=spec, start=nb, elapsed=float(elapsed),
                          finish=finish, mask=mask)
        self.results[spec.name] = res
        self.last = spec.name
        return res

    @property
    def makespan(self) -> float:
        if not self.results:
            return 0.0
        return max(r.finish for r in self.results.values()) - self.start


def run_dag(clock, key: torch.Tensor, specs: Sequence[PhaseSpec], *,
            sequential: bool = False,
            start: Optional[float] = None) -> DagResult:
    """Validate, canonicalize and dispatch a whole phase DAG: the dispatch
    order, hence every draw, pool interaction and ledger addition, is a
    function of the DAG alone.  ``sequential`` dispatches the same order
    with every edge a barrier at the current clock."""
    order = canonical_order(specs)
    run = DagRun(clock, key=key, start=start)
    for s in order:
        run.dispatch(s, sequential=sequential)
    return DagResult(order=[s.name for s in order], results=run.results,
                     start=run.start, makespan=run.makespan)
