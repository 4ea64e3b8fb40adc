"""Multi-tenant workload: registered job templates + seeded arrivals;
port of ``repro/tenancy/workload.py``.

The paper's economic argument (Sec. 5: ~3000 transient Lambda workers
beating a fixed cluster on dollars) presumes a *shared* platform; a
workload is the demand side of that platform.  A ``JobTemplate`` declares
one job class — a tenant label, a per-iteration ``PhaseSpec`` DAG (the
same declaration the single-job scheduler runs), an iteration count, and
an optional relative deadline (the job's SLO).  Templates live in a
process-global registry like sketch families do, so benchmarks and traces
refer to them by name.

``generate_workload`` draws a seeded Poisson arrival process over a
template mix (``numpy.random.default_rng(seed)`` — same trace for the
same config, forever); ``workload_from_trace`` replays explicit
``(arrival_time, template)`` rows instead.  Either way the output is a
flat, arrival-sorted list of ``Job``s for ``tenancy.JobScheduler``.

Template-level estimates (``expected_makespan`` / ``phase_slack`` /
``expected_peak_workers``) run CPM on *median* phase durations from the
``StragglerModel`` price sheet — estimates for admission control and
autoscaling, not ground truth: the simulated fleet still draws straggler
tails, cold starts, and retries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.obs.critical_path import critical_path
from repro_torch.scheduler.spec import PhaseSpec, canonical_order


@dataclasses.dataclass(frozen=True)
class JobTemplate:
    """One registered job class: a named, deadline-bearing iteration DAG."""

    name: str
    tenant: str
    specs: Tuple[PhaseSpec, ...]
    iters: int = 1
    # Relative SLO: the job should finish within deadline_s of ARRIVAL
    # (queueing included).  None = best-effort tenant, never rejected on
    # feasibility and never counted as an SLO miss.
    deadline_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        canonical_order(self.specs)     # validates names/deps/cycles
        if not self.name:
            raise ValueError("template needs a non-empty name")
        if not self.tenant:
            raise ValueError(f"template {self.name!r}: needs a tenant")
        if self.iters < 1:
            raise ValueError(f"template {self.name!r}: iters must be >= 1")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"template {self.name!r}: deadline_s must be > 0")

    # ------------------------------------------------- planning estimates
    @staticmethod
    def expected_duration(spec: PhaseSpec, model) -> float:
        """Median duration of one phase: invoke overhead + median body
        (lognormal median = base_time * work) + master comm."""
        work = (spec.flops_per_worker / model.flops_per_second
                if spec.flops_per_worker is not None
                else spec.work_per_worker)
        return (model.invoke_overhead + model.base_time * work
                + model.comm_per_unit * spec.comm_units)

    def expected_schedule(self, model) -> Dict[str, tuple]:
        """CPM forward pass over ONE iteration: name -> (start, finish,
        deps) under median durations, iteration starting at 0."""
        finish: Dict[str, float] = {}
        sched: Dict[str, tuple] = {}
        for spec in canonical_order(self.specs):
            start = max((finish[d] for d in spec.deps), default=0.0)
            end = start + self.expected_duration(spec, model)
            finish[spec.name] = end
            sched[spec.name] = (start, end, spec.deps)
        return sched

    def expected_makespan(self, model) -> float:
        """Median end-to-end runtime: iterations are sequential barriers."""
        sched = self.expected_schedule(model)
        return self.iters * max(f for _, f, _ in sched.values())

    def phase_slack(self, model) -> Dict[str, float]:
        """Static per-phase CPM slack (seconds a phase can be delayed
        without moving the iteration makespan) — the budget pool-aware
        dispatch spends converting cold starts into warm hits."""
        report = critical_path(self.expected_schedule(model), start=0.0)
        return {n: p.slack for n, p in report.phases.items()}

    def expected_peak_workers(self, model) -> int:
        """Peak concurrent containers under the median schedule — the
        autoscaler's per-job capacity demand."""
        sched = self.expected_schedule(model)
        by_name = {s.name: s for s in self.specs}
        events: List[Tuple[float, int]] = []
        for name, (s, f, _) in sched.items():
            events.append((s, by_name[name].workers))
            events.append((f, -by_name[name].workers))
        events.sort()
        peak = cur = 0
        for _, dw in events:
            cur += dw
            peak = max(peak, cur)
        return peak


# ------------------------------------------------------------- registry
_TEMPLATES: Dict[str, JobTemplate] = {}


def register(template: JobTemplate, *, overwrite: bool = False
             ) -> JobTemplate:
    if template.name in _TEMPLATES and not overwrite:
        raise ValueError(f"job template {template.name!r} already "
                         f"registered (overwrite=True to replace)")
    _TEMPLATES[template.name] = template
    return template


def get_template(name: str) -> JobTemplate:
    try:
        return _TEMPLATES[name]
    except KeyError:
        raise KeyError(f"unknown job template {name!r}; registered: "
                       f"{available_templates()}") from None


def available_templates() -> List[str]:
    return sorted(_TEMPLATES)


# ------------------------------------------------------------- arrivals
@dataclasses.dataclass(frozen=True)
class Job:
    """One arrival: a template instance with an id and an absolute clock."""

    id: int
    template: JobTemplate
    t_arrival: float

    @property
    def tenant(self) -> str:
        return self.template.tenant

    @property
    def deadline(self) -> Optional[float]:
        d = self.template.deadline_s
        return None if d is None else self.t_arrival + d


DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("newton_small", 0.45), ("newton_large", 0.15),
    ("giant", 0.15), ("matvec", 0.25))


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Seeded Poisson arrival process over a template mix."""

    seed: int = 0
    rate: float = 4.0               # mean arrivals per simulated second
    n_jobs: int = 100
    mix: Tuple[Tuple[str, float], ...] = DEFAULT_MIX


def generate_workload(cfg: WorkloadConfig) -> List[Job]:
    """Draw the arrival trace: exponential inter-arrival gaps + weighted
    template picks, all from one ``default_rng(cfg.seed)`` stream."""
    if cfg.n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {cfg.n_jobs}")
    if cfg.rate <= 0:
        raise ValueError(f"rate must be > 0, got {cfg.rate}")
    names = [n for n, _ in cfg.mix]
    weights = np.asarray([w for _, w in cfg.mix], dtype=float)
    if len(names) == 0 or (weights < 0).any() or weights.sum() <= 0:
        raise ValueError(f"bad template mix: {cfg.mix!r}")
    templates = [get_template(n) for n in names]
    rng = np.random.default_rng(cfg.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / cfg.rate, size=cfg.n_jobs))
    picks = rng.choice(len(names), size=cfg.n_jobs,
                       p=weights / weights.sum())
    return [Job(i, templates[int(picks[i])], float(arrivals[i]))
            for i in range(cfg.n_jobs)]


def workload_from_trace(rows) -> List[Job]:
    """Trace-driven arrivals: ``rows`` is an iterable of ``(t, template)``
    pairs or ``{"t": ..., "template": ...}`` dicts.  Job ids follow the
    input order; the returned list is arrival-sorted (id tiebreak), the
    canonical event order the scheduler consumes."""
    jobs = []
    for i, row in enumerate(rows):
        if isinstance(row, Mapping):
            t, name = row["t"], row["template"]
        else:
            t, name = row
        jobs.append(Job(i, get_template(str(name)), float(t)))
    jobs.sort(key=lambda j: (j.t_arrival, j.id))
    return jobs


# ------------------------------------------- default template catalogue
# Small, fast shapes (fleet phases are ~0.2-0.5 simulated seconds) so the
# 1k-10k job benchmark sweeps stay tractable; worker counts and the
# grad || hess -> linesearch shape mirror scheduler_bench's Newton DAG.
register(JobTemplate(
    name="newton_small", tenant="batch", iters=1, deadline_s=6.0,
    specs=(PhaseSpec("grad", workers=6, policy="k_of_n", k=5,
                     flops_per_worker=3e5),
           PhaseSpec("hess", workers=10, policy="k_of_n", k=8,
                     flops_per_worker=4e5),
           PhaseSpec("linesearch", workers=4, flops_per_worker=2e5,
                     deps=("grad", "hess")))))
register(JobTemplate(
    name="newton_large", tenant="batch", iters=2, deadline_s=20.0,
    specs=(PhaseSpec("grad", workers=12, policy="k_of_n", k=10,
                     flops_per_worker=6e5),
           PhaseSpec("hess", workers=24, policy="k_of_n", k=20,
                     flops_per_worker=8e5),
           PhaseSpec("linesearch", workers=6, flops_per_worker=3e5,
                     deps=("grad", "hess")))))
register(JobTemplate(
    name="giant", tenant="train", iters=2, deadline_s=10.0,
    specs=(PhaseSpec("local", workers=8, policy="k_of_n", k=6,
                     flops_per_worker=5e5),
           PhaseSpec("reduce", workers=4, flops_per_worker=2e5,
                     comm_units=1.0, deps=("local",)))))
register(JobTemplate(
    name="matvec", tenant="serving", iters=1, deadline_s=2.0,
    specs=(PhaseSpec("matvec", workers=8, policy="k_of_n", k=6,
                     flops_per_worker=2e5, comm_units=1.0),)))
