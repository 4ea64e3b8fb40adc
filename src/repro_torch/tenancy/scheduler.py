"""Job-level scheduler: many tenants, one fleet, one WarmPool, one ledger;
port of ``repro/tenancy/scheduler.py``.  ``prng.fold_in`` folds the job,
iteration and phase keys as the reference's ``jax.random.fold_in`` does,
so every phase's draws are the reference's bit for bit.

``JobScheduler`` turns the single-job discrete-event engine into a
platform simulator.  It consumes a workload (``tenancy.workload``) and
drives every job's phase DAG through ONE shared ``SimClock`` — so every
job's phases acquire containers from the same ``scheduler.WarmPool``,
bill the same ``CostLedger``, and appear on the same telemetry stream.

Canonical event order (the determinism contract):

  Events live on one heap keyed ``(t, rank, job_id, iteration, phase)``
  with rank arrival(0) < phase(1) < completion(2).  Same seed + same
  arrival trace => the same pop order => the same pool acquire/release
  interleaving => bit-identical warm/cold assignment, elapsed seconds,
  and dollars.  Phase PRNG keys fold (job id, iteration, name-CRC) into
  the run key, so a job's randomness is a function of its identity, not
  of its neighbours.

Admission (``AdmissionPolicy``): a platform concurrency cap with an
optional FIFO queue, plus SLO-aware rejection — a job whose *estimated*
completion (CPM median makespan x ``est_safety``, from its predicted
admission slot) already misses its deadline is refused at arrival rather
than admitted to fail.  The estimate is optimistic (it ignores straggler
tails and pool contention); admission is a policy, not an oracle.

Pool-aware dispatch (``TenancyConfig.pool_aware``): an off-critical-path
phase may be delayed within its static CPM slack to a moment when more
warm containers are free (``WarmPool.earliest_fit``), converting cold
starts into warm hits for free — the slack budget ``obs.critical_path``
measures is exactly what this spends.

Autoscaling + provisioned billing (``Autoscaler``): the provisioned
(pinned-warm) reserve tracks the observed arrival rate via Little's law
— target containers ~= headroom x rate x (median makespan x peak
workers per job) — EWMA-smoothed, clamped, refreshed on every arrival.
The reserve bills ``CostModel.usd_per_provisioned_gb_second`` for every
GB-second it is *configured*, used or not (that is what provisioned
concurrency costs), accrued piecewise-constant into the shared ledger's
``provisioned_gb_seconds`` and attributed to the ``_platform`` tenant.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import prng
from repro_torch.runtime.cost import CostLedger
from repro_torch.runtime.faults import PhaseExhaustedError
from repro_torch.scheduler.spec import PhaseSpec, canonical_order
from repro_torch.tenancy.workload import Job

_ARRIVE, _PHASE, _COMPLETE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Platform admission knobs (see module docstring)."""

    max_inflight: int = 64        # concurrent-jobs cap
    queue: bool = True            # hold for a slot (FIFO) vs reject at cap
    slo_aware: bool = True        # reject jobs whose estimate misses SLO
    est_safety: float = 1.5       # multiplier on the median-CPM estimate
    # Error-budget-aware shedding (obs.slo): when the run carries
    # per-tenant SLO policies (TenancyConfig.slo), reject arrivals from
    # exactly the tenant whose budget is exhausted or whose fast+slow
    # burn windows are both paging — the burning tenant sheds, everyone
    # else is untouched.  Off by default: SLO tracking alone is pure
    # observation; this flag is the explicit opt-in that lets it steer.
    budget_aware: bool = False


@dataclasses.dataclass(frozen=True)
class Autoscaler:
    """Arrival-rate-tracking provisioned-concurrency policy."""

    alpha: float = 0.3            # EWMA weight on new observations
    headroom: float = 1.2         # over-provisioning factor
    min_provisioned: int = 0
    max_provisioned: int = 512

    def target(self, rate: float, demand_per_job: float) -> int:
        """Little's law: containers ~= rate [jobs/s] x demand
        [container-seconds/job], plus headroom."""
        raw = self.headroom * rate * demand_per_job
        return max(self.min_provisioned,
                   min(self.max_provisioned, int(math.ceil(raw))))


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    admission: AdmissionPolicy = AdmissionPolicy()
    autoscaler: Optional[Autoscaler] = None
    pool_aware: bool = False
    slack_safety: float = 1.0     # fraction of static slack spendable
    # Per-tenant objectives (tenant name -> obs.slo.SloPolicy).
    # When set, a SloTracker folds every completed job into error budgets
    # and burn rates; AdmissionPolicy.budget_aware decides whether that
    # state may also shed arrivals.  None = no SLO plane (default).
    slo: Optional[Dict[str, "object"]] = None


@dataclasses.dataclass
class JobRecord:
    """Outcome of one job, in arrival order on ``FleetResult.jobs``."""

    id: int
    tenant: str
    template: str
    t_arrival: float
    deadline: Optional[float]
    t_admit: Optional[float] = None
    t_finish: Optional[float] = None
    rejected: bool = False
    failed: bool = False
    dollars: float = 0.0

    @property
    def completed(self) -> bool:
        return self.t_finish is not None and not self.failed

    @property
    def latency(self) -> Optional[float]:
        return (None if self.t_finish is None
                else self.t_finish - self.t_arrival)

    @property
    def queue_wait(self) -> Optional[float]:
        return (None if self.t_admit is None
                else self.t_admit - self.t_arrival)

    @property
    def slo_missed(self) -> bool:
        """An admitted, deadline-bearing job that failed or finished late."""
        if self.rejected or self.deadline is None:
            return False
        return self.failed or (self.t_finish is not None
                               and self.t_finish > self.deadline)


@dataclasses.dataclass
class FleetResult:
    """One multi-tenant run: per-job outcomes + shared-platform totals."""

    jobs: List[JobRecord]
    seconds: float                    # fleet makespan (engine clock)
    dollars: float                    # everything, provisioned included
    tenants: Dict[str, CostLedger]    # per-tenant attribution (+ _platform)
    provisioned_gb_seconds: float
    peak_inflight: int                # max concurrently-admitted jobs
    # (job_id, iteration, phase, t_launch, warm_hits, cold_starts) per
    # dispatched phase — the warm/cold assignment determinism tests pin.
    phase_log: List[Tuple[int, int, str, float, int, int]]

    @property
    def completed(self) -> List[JobRecord]:
        return [j for j in self.jobs if j.completed]

    @property
    def rejected(self) -> List[JobRecord]:
        return [j for j in self.jobs if j.rejected]

    @property
    def failed(self) -> List[JobRecord]:
        return [j for j in self.jobs if j.failed]

    @property
    def slo_misses(self) -> int:
        return sum(j.slo_missed for j in self.jobs)

    @property
    def throughput(self) -> float:
        """Completed jobs per simulated second."""
        return len(self.completed) / self.seconds if self.seconds else 0.0

    def latency_quantile(self, q: float) -> float:
        lats = sorted(j.latency for j in self.completed)
        if not lats:
            return float("nan")
        i = min(len(lats) - 1, max(0, int(math.ceil(q * len(lats))) - 1))
        return lats[i]

    def summary(self) -> dict:
        return {"jobs": len(self.jobs),
                "completed": len(self.completed),
                "rejected": len(self.rejected),
                "failed": len(self.failed),
                "slo_misses": self.slo_misses,
                "seconds": self.seconds,
                "dollars": self.dollars,
                "provisioned_gb_seconds": self.provisioned_gb_seconds,
                "throughput": self.throughput,
                "peak_inflight": self.peak_inflight,
                "latency_p50": self.latency_quantile(0.50),
                "latency_p95": self.latency_quantile(0.95)}


class _TemplateInfo:
    """Static per-template scheduling data, computed once per run."""

    def __init__(self, template, model):
        self.specs: List[PhaseSpec] = canonical_order(template.specs)
        self.by_name = {s.name: s for s in self.specs}
        self.succs: Dict[str, List[str]] = {s.name: [] for s in self.specs}
        self.ndeps: Dict[str, int] = {}
        for s in self.specs:
            self.ndeps[s.name] = len(s.deps)
            for d in s.deps:
                self.succs[d].append(s.name)
        self.slack = template.phase_slack(model)
        self.est_makespan = template.expected_makespan(model)
        self.demand = self.est_makespan * template.expected_peak_workers(
            model) / max(1, template.iters)  # per-job container-seconds


class _JobState:
    __slots__ = ("job", "info", "job_key", "it_key", "iteration",
                 "remaining", "ndeps", "finish", "failed")

    def __init__(self, job, info, job_key):
        self.job = job
        self.info = info
        self.job_key = job_key
        self.failed = False
        self._start_iteration(0)

    def _start_iteration(self, i: int) -> None:
        self.iteration = i
        self.it_key = prng.fold_in(self.job_key, i)
        self.remaining = len(self.info.specs)
        self.ndeps = dict(self.info.ndeps)
        self.finish: Dict[str, float] = {}


class JobScheduler:
    """Drive a workload through one shared ``SimClock`` (see module doc).

    ``clock`` carries the shared engine: its pool, telemetry, recorder,
    and fault plan apply to every tenant.  ``key`` is the run's PRNG
    root; each phase's key folds (job id, iteration, phase-name CRC)
    into it."""

    def __init__(self, clock, key: torch.Tensor, jobs: Sequence[Job],
                 config: TenancyConfig = TenancyConfig()):
        ids = [j.id for j in jobs]
        if len(set(ids)) != len(ids):
            raise ValueError("job ids must be unique")
        self.clock = clock
        self.engine = clock.engine
        self.key = key
        self.jobs = sorted(jobs, key=lambda j: (j.t_arrival, j.id))
        self.config = config
        self.pool = self.engine.pool
        model = clock.model
        self._info: Dict[str, _TemplateInfo] = {}
        for j in self.jobs:
            if j.template.name not in self._info:
                self._info[j.template.name] = _TemplateInfo(j.template,
                                                            model)
        # --- mutable run state
        self._records: Dict[int, JobRecord] = {}
        self._states: Dict[int, _JobState] = {}
        self._inflight: Dict[int, float] = {}    # job id -> est finish
        self._peak_inflight = 0
        self._fifo: List[int] = []               # queued job ids
        self._phase_log: List[Tuple] = []
        self._tenants: Dict[str, CostLedger] = {}
        # --- provisioned-concurrency accrual (billed by configured target)
        self._mem_gb = self.engine.cost_model.memory_gb
        self._prov_target = self.pool.fresh if self.pool is not None else 0
        self._prov_t = self.engine.seconds
        self._prov_gbs = 0.0
        # --- autoscaler EWMA state
        self._last_arrival: Optional[float] = None
        self._ewma_gap: Optional[float] = None
        self._ewma_demand: Optional[float] = None
        # --- per-tenant SLO plane (obs.slo)
        self.slo_tracker = None
        if config.slo:
            from repro_torch.obs.slo import SloTracker
            self.slo_tracker = SloTracker(config.slo,
                                          telemetry=clock.telemetry)
            # Surface the tracker on the telemetry so exports/store pick
            # it up — but never set attributes on the shared obs.NULL.
            if getattr(clock.telemetry, "enabled", False):
                clock.telemetry.slo = self.slo_tracker

    # --------------------------------------------------------- telemetry
    @property
    def _m(self):
        return self.clock.telemetry.metrics

    def _tenant_ledger(self, tenant: str) -> CostLedger:
        led = self._tenants.get(tenant)
        if led is None:
            led = self._tenants[tenant] = CostLedger()
        return led

    # ------------------------------------------------------- provisioned
    def _accrue_provisioned(self, t: float) -> None:
        dt = t - self._prov_t
        if dt > 0 and self._prov_target > 0:
            gbs = self._prov_target * self._mem_gb * dt
            self._prov_gbs += gbs
            self.engine.ledger.provisioned_gb_seconds += gbs
            self._tenant_ledger("_platform").provisioned_gb_seconds += gbs
        self._prov_t = max(self._prov_t, t)

    def _set_provisioned(self, t: float, target: int) -> None:
        """Re-point the pinned-warm reserve: accrue at the old target,
        then top up / cool the pool toward the new one (the reserve is
        *refreshed* — consumed provisioned containers are replaced)."""
        self._accrue_provisioned(t)
        self._prov_target = target
        if self.pool.fresh < target:
            self.pool.prewarm(target - self.pool.fresh)
        elif self.pool.fresh > target:
            self.pool.cool(self.pool.fresh - target)
        self._m.gauge("pool.provisioned").set(target)

    def _autoscale(self, t: float, info: _TemplateInfo) -> None:
        auto = self.config.autoscaler
        if auto is None or self.pool is None:
            return
        if self._last_arrival is not None:
            gap = max(1e-9, t - self._last_arrival)
            self._ewma_gap = (gap if self._ewma_gap is None
                              else auto.alpha * gap
                              + (1 - auto.alpha) * self._ewma_gap)
        self._last_arrival = t
        self._ewma_demand = (info.demand if self._ewma_demand is None
                             else auto.alpha * info.demand
                             + (1 - auto.alpha) * self._ewma_demand)
        if self._ewma_gap is None:
            return                      # one arrival: no rate estimate yet
        target = auto.target(1.0 / self._ewma_gap, self._ewma_demand)
        if target != self._prov_target:
            self._set_provisioned(t, target)

    # --------------------------------------------------------- admission
    def _estimate(self, job: Job) -> float:
        return (self._info[job.template.name].est_makespan
                * self.config.admission.est_safety)

    def _predicted_start(self, t: float, queue_pos: int) -> float:
        """Optimistic slot prediction for a job ``queue_pos`` deep in the
        FIFO: the (pos+1)-th soonest estimated finish among inflight
        jobs (ignores contention — admission is advisory)."""
        if not self._inflight:
            return t
        ests = sorted(self._inflight.values())
        return max(t, ests[min(queue_pos, len(ests) - 1)])

    def _try_admit(self, heap, job: Job, t: float) -> None:
        adm = self.config.admission
        if (adm.budget_aware and self.slo_tracker is not None
                and self.slo_tracker.should_shed(job.tenant, t)):
            self._reject(job)
            self._m.counter(f"tenant.{job.tenant}.budget_shed").inc()
            return
        if adm.slo_aware and job.deadline is not None:
            start = (t if len(self._inflight) < adm.max_inflight
                     else self._predicted_start(t, len(self._fifo)))
            if start + self._estimate(job) > job.deadline:
                self._reject(job)
                return
        if len(self._inflight) < adm.max_inflight:
            self._admit(heap, job, t)
        elif adm.queue:
            self._fifo.append(job.id)
        else:
            self._reject(job)

    def _reject(self, job: Job) -> None:
        self._records[job.id].rejected = True
        m = self._m
        m.counter("jobs.rejected").inc()
        m.counter(f"tenant.{job.tenant}.rejected").inc()

    def _admit(self, heap, job: Job, t: float) -> None:
        info = self._info[job.template.name]
        st = _JobState(job, info, prng.fold_in(self.key, job.id))
        self._states[job.id] = st
        self._records[job.id].t_admit = t
        self._inflight[job.id] = t + self._estimate(job)
        self._peak_inflight = max(self._peak_inflight, len(self._inflight))
        m = self._m
        m.counter("jobs.admitted").inc()
        m.histogram("job.queue_wait_s").observe(t - job.t_arrival)
        m.gauge("fleet.inflight").set(len(self._inflight))
        self._push_ready(heap, st, t)

    def _push_ready(self, heap, st: _JobState, t_start: float) -> None:
        """Queue this iteration's root phases, ready at ``t_start``."""
        for spec in st.info.specs:
            if not spec.deps:
                heapq.heappush(heap, (t_start, _PHASE, st.job.id,
                                      st.iteration, spec.name))

    # ---------------------------------------------------------- dispatch
    def _dispatch(self, heap, st: _JobState, name: str, t_ready: float
                  ) -> None:
        job, info, cfg = st.job, st.info, self.config
        spec = info.by_name[name]
        t_launch = t_ready
        if (cfg.pool_aware and self.pool is not None
                and info.slack.get(name, 0.0) > 0.0):
            budget = cfg.slack_safety * info.slack[name]
            t_launch = self.pool.earliest_fit(t_ready, spec.workers,
                                              t_ready + budget)
        led = self.engine.ledger
        before = (led.gb_seconds, led.invocations, led.s3_puts,
                  led.s3_gets)
        warm0, cold0 = ((self.pool.warm_hits, self.pool.cold_starts)
                        if self.pool is not None else (0, 0))
        label = f"{job.tenant}/{job.id}/{name}"
        pkey = prng.fold_in(st.it_key, spec.key_fold)
        try:
            elapsed, _ = self.clock.phase(
                pkey, spec.workers, work_per_worker=spec.work_per_worker,
                flops_per_worker=spec.flops_per_worker, policy=spec.policy,
                k=spec.k, comm_units=spec.comm_units,
                decodable=spec.decodable, not_before=t_launch,
                memory_gb=spec.memory_gb,
                working_set_gb=spec.working_set_gb, phase_name=label,
                phase_deps=tuple(f"{job.tenant}/{job.id}/{d}"
                                 for d in spec.deps))
            finish = t_launch + float(elapsed)
        except PhaseExhaustedError as err:
            finish = t_launch + err.elapsed
            st.failed = True
        # Per-tenant attribution: the ledger-field deltas of this phase.
        tled = self._tenant_ledger(job.tenant)
        tled.gb_seconds += led.gb_seconds - before[0]
        tled.invocations += led.invocations - before[1]
        tled.s3_puts += led.s3_puts - before[2]
        tled.s3_gets += led.s3_gets - before[3]
        self._records[job.id].dollars += self.engine.cost_model.dollars(
            led.gb_seconds - before[0], led.invocations - before[1],
            led.s3_puts - before[2], led.s3_gets - before[3])
        if self.pool is not None:
            self._phase_log.append(
                (job.id, st.iteration, name, t_launch,
                 self.pool.warm_hits - warm0,
                 self.pool.cold_starts - cold0))
        else:
            self._phase_log.append(
                (job.id, st.iteration, name, t_launch, 0, 0))
        if st.failed:
            heapq.heappush(heap, (finish, _COMPLETE, job.id, 0, ""))
            return
        st.finish[name] = finish
        st.remaining -= 1
        for succ in info.succs[name]:
            st.ndeps[succ] -= 1
            if st.ndeps[succ] == 0:
                ready = max(st.finish[d]
                            for d in info.by_name[succ].deps)
                heapq.heappush(heap, (ready, _PHASE, job.id,
                                      st.iteration, succ))
        if st.remaining == 0:
            it_end = max(st.finish.values())
            if st.iteration + 1 < job.template.iters:
                st._start_iteration(st.iteration + 1)
                self._push_ready(heap, st, it_end)
            else:
                heapq.heappush(heap, (it_end, _COMPLETE, job.id, 0, ""))

    # ---------------------------------------------------------- complete
    def _complete(self, job_id: int, t: float) -> None:
        rec = self._records[job_id]
        job = self._states[job_id].job
        rec.t_finish = t
        rec.failed = self._states[job_id].failed
        self._inflight.pop(job_id, None)
        m = self._m
        m.counter("jobs.failed" if rec.failed else "jobs.completed").inc()
        if rec.latency is not None:
            m.histogram("job.latency_s").observe(rec.latency)
        if rec.slo_missed:
            m.counter("jobs.slo_missed").inc()
        m.gauge("fleet.inflight").set(len(self._inflight))
        tled = self._tenant_ledger(job.tenant)
        m.gauge(f"tenant.{job.tenant}.dollars").set(
            tled.dollars(self.engine.cost_model))
        extra = {}
        if self.slo_tracker is not None:
            # Fold the outcome into the tenant's error budget, and stamp
            # the job span with a warm-pool snapshot so incident
            # attribution can see the pool state each job finished under.
            self.slo_tracker.record_job(
                job.tenant, t, rec.latency or 0.0,
                deadline_missed=(rec.deadline is not None
                                 and t > rec.deadline),
                failed=rec.failed, dollars=rec.dollars)
            extra["budget_remaining"] = self.slo_tracker.budget_remaining(
                job.tenant)
            if self.pool is not None:
                extra["pool_free"] = self.pool.free_at(t)
        self.clock.telemetry.trace.emit(
            f"job/{job.tenant}/{job_id}", "job", job.t_arrival, t,
            track=f"tenant/{job.tenant}", tenant=job.tenant,
            template=job.template.name, latency=rec.latency,
            queue_wait=rec.queue_wait, failed=rec.failed,
            slo_missed=rec.slo_missed, **extra)

    # --------------------------------------------------------------- run
    def run(self) -> FleetResult:
        heap: List[Tuple] = []
        self._job_by_id = {j.id: j for j in self.jobs}
        for job in self.jobs:
            self._records[job.id] = JobRecord(
                id=job.id, tenant=job.tenant, template=job.template.name,
                t_arrival=job.t_arrival, deadline=job.deadline)
            heapq.heappush(heap, (job.t_arrival, _ARRIVE, job.id, 0, ""))
        m = self._m
        while heap:
            t, rank, job_id, _it, name = heapq.heappop(heap)
            if rank == _ARRIVE:
                job = self._job_by_id[job_id]
                m.counter("jobs.arrived").inc()
                m.counter(f"tenant.{job.tenant}.jobs").inc()
                self._autoscale(t, self._info[job.template.name])
                self._try_admit(heap, job, t)
            elif rank == _PHASE:
                st = self._states[job_id]
                if st.failed:
                    continue            # job aborted mid-iteration
                self._dispatch(heap, st, name, t)
            else:
                self._complete(job_id, t)
                adm = self.config.admission
                while (self._fifo
                       and len(self._inflight) < adm.max_inflight):
                    self._admit(heap, self._job_by_id[self._fifo.pop(0)],
                                t)
        end = self.engine.seconds
        self._accrue_provisioned(end)
        return FleetResult(
            jobs=[self._records[j.id] for j in self.jobs],
            seconds=end, dollars=self.engine.dollars,
            tenants=self._tenants,
            provisioned_gb_seconds=self._prov_gbs,
            peak_inflight=self._peak_inflight,
            phase_log=self._phase_log)
