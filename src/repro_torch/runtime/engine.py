"""Discrete-event serverless fleet engine; port of ``repro/runtime/engine.py``.

``FleetEngine`` is the substrate every optimizer is scored on.  One
``run_phase`` call simulates one distributed round:

  1. Each worker is launched at t=0.  An attempt may hit a **cold start**
     (probability ``cold_start_prob``, or the attached ``WarmPool`` has no
     free container at its absolute launch time; extra U[lo, hi] delay),
     then runs for a duration drawn from the ``StragglerModel``.
  2. An attempt may **fail** mid-run (probability ``failure_rate``), or die
     of an injected fault (``runtime.faults``: burst, OOM); the master
     relaunches it after ``retry_backoff``.  Under ``fail_open`` the
     attempt at index ``max_retries`` always succeeds; otherwise a worker
     whose last attempt dies is exhausted and the phase may raise
     ``PhaseExhaustedError``.  A throttle cap re-queues launches, S3
     transients delay them.
  3. The phase's termination policy (``runtime.policies``) decides the
     master's wait and the result mask, possibly adding relaunches.
  4. Every attempt is billed through the ``CostModel``, and the phase is
     appended to the trace recorder if one is attached.  With a replayer
     attached, each phase and charge re-applies a recorded row instead.

The fleet is host-side numpy, as in the reference: run durations come from
``model.sample_times`` under keys folded from the phase key, lifecycle
coin flips from a numpy ``Generator`` seeded with the key's two uint32
words, and injected faults from a second generator folded from the key and
the plan's seed, so identical keys give identical ``(seconds, dollars)``
and trace rows in both packages.  Live telemetry waits for ROADMAP Queue 1
item 10 (``telemetry=`` raises); ``telemetry`` is the no-op ``obs.NULL``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.runtime import policies as _policies
from repro_torch.runtime import trace as _trace
from repro_torch.runtime.cost import CostLedger, CostModel, bill_phase
from repro_torch.runtime.faults import FaultPlan, PhaseExhaustedError


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Worker-lifecycle knobs layered on the StragglerModel; all off by
    default (the pure order-statistic clock)."""

    cold_start_prob: float = 0.0
    cold_start_lo: float = 0.5
    cold_start_hi: float = 2.0
    failure_rate: float = 0.0
    max_retries: int = 3
    retry_backoff: float = 0.05
    watch_fraction: float = 0.9
    hedge_quantile: float = 0.8
    # fail_open=False makes the retry budget real: a worker whose final
    # attempt dies is exhausted, and a phase that cannot terminate without
    # it raises ``PhaseExhaustedError``.
    fail_open: bool = True


def _np_rng(key: torch.Tensor) -> np.random.Generator:
    """Numpy generator seeded with the key's two uint32 words."""
    return np.random.default_rng(prng.key_data(key).ravel().tolist())


class FleetEngine:
    """Accumulates simulated seconds and dollars across phases."""

    def __init__(self, model, fleet: Optional[FleetConfig] = None,
                 cost: Optional[CostModel] = None,
                 recorder=None, replay=None, pool=None, telemetry=None,
                 faults: Optional[FaultPlan] = None):
        if telemetry is not None:
            raise NotImplementedError(
                "live telemetry is not ported yet (ROADMAP Queue 1 item 10)")
        self.model = model
        self.fleet = fleet if fleet is not None else FleetConfig()
        self.cost_model = cost if cost is not None else CostModel()
        self.ledger = CostLedger()
        self.seconds = 0.0
        self.recorder = recorder     # runtime.TraceRecorder
        self.replay = replay         # runtime.TraceReplayer
        self.pool = pool             # scheduler.WarmPool (None: i.i.d. colds)
        self.telemetry = obs.NULL
        # Deterministic chaos injected into every phase; its draws come
        # from a generator of its own, never from the lifecycle stream.
        self.faults = faults
        # Per-worker corruption flags of the most recent phase (None unless
        # the plan has a CorruptionSpec or a replayed row carries them).
        self.last_corruption: Optional[np.ndarray] = None
        self._pool_death_done = False
        self._phase_idx = 0

    @property
    def dollars(self) -> float:
        return self.ledger.dollars(self.cost_model)

    def charge(self, elapsed: float, phase_name: Optional[str] = None
               ) -> None:
        """Add externally computed phase time (no workers billed).
        ``phase_name`` labels the reference's telemetry span, unused here."""
        if self.replay is not None:
            elapsed = self.replay.next_charge()
        elapsed = float(elapsed)
        self.seconds += elapsed
        if self.recorder is not None:
            self.recorder.record_charge(self._phase_idx, elapsed)
        self._phase_idx += 1

    def _lifecycle(self, key: torch.Tensor, rng: np.random.Generator,
                   num_workers: int, work_per_worker: float,
                   flops_per_worker: Optional[float], t0: float = 0.0, *,
                   frng: Optional[np.random.Generator] = None,
                   eff_memory_gb: float = 0.0,
                   working_set_gb: Optional[float] = None
                   ) -> Tuple[np.ndarray, List[tuple], int, dict]:
        """Event-driven per-worker lifecycle: cold start -> running ->
        done | killed-with-retry | exhausted.  Returns (completion times,
        billed attempts, successes, stats); an attempt is (launch, end), or
        (launch, end, mem_scale) after an OOM escalation.  ``t0`` is the
        phase's absolute launch time (the pool and the fault windows are
        read at ``t0 + event time``); ``frng`` is present iff a fault plan
        is active and feeds every injected-fault draw.  An attempt dies of
        OOM, a burst or the i.i.d. failure coin, the earliest first."""
        fl = self.fleet
        fp = self.faults if frng is not None else None
        round_times: dict = {}
        stats = {"retries": 0, "warm": 0, "cold": 0,
                 "cold_delays": [], "exhausted": 0}   # type: dict
        fstats = None
        if fp is not None:
            fstats = {"burst_kills": 0, "burst_exposed": 0, "throttled": 0,
                      "s3_get_retries": 0, "s3_put_retries": 0,
                      "oom_kills": 0, "oom_escalations": 0,
                      "pool_killed": 0, "peak_concurrency": 0,
                      "throttle_waits": []}
            stats["faults"] = fstats

        def duration(worker: int, attempt: int) -> float:
            # One sample round per retry wave, lazily: the common
            # failure-free case costs exactly one sample_times call.
            if attempt not in round_times:
                k = prng.fold_in(key, attempt)
                round_times[attempt] = self.model.sample_times(
                    k, num_workers, work_per_worker,
                    flops_per_worker).numpy().astype(np.float64)
            return float(round_times[attempt][worker])

        done = np.full(num_workers, np.inf)
        attempts: List[tuple] = []
        successes = 0
        mem_scale = np.ones(num_workers)   # >1 only after OOM escalation
        running: list = []  # end-times heap of admitted in-flight attempts
        th = fp.throttle if fp is not None else None
        s3 = fp.s3 if fp is not None else None
        events: list = []   # (time, seq, worker, attempt, backoff_tries)
        for w in range(num_workers):
            heapq.heappush(events, (0.0, w, w, 0, 0))
        seq = num_workers
        while events:
            t, _, w, attempt, tries = heapq.heappop(events)
            if th is not None:
                while running and running[0] <= t:
                    heapq.heappop(running)
                if (th.t_start <= t0 + t < th.t_end
                        and len(running) >= th.max_concurrent):
                    # Rejected by the concurrency cap: re-queue after
                    # exponential backoff + jitter.  The rejected request
                    # is still billed as an invocation (run_phase adds it).
                    wait = (th.backoff * th.backoff_mult ** tries
                            + frng.uniform(0.0, th.jitter))
                    fstats["throttled"] += 1
                    fstats["throttle_waits"].append(float(wait))
                    heapq.heappush(events,
                                   (t + wait, seq, w, attempt, tries + 1))
                    seq += 1
                    continue
            if self.pool is not None:
                # Warm-pool model: cold exactly when no unexpired container
                # is free at the attempt's absolute launch time.
                cold = not self.pool.acquire(t0 + t)
            else:
                cold = (fl.cold_start_prob > 0.0
                        and rng.random() < fl.cold_start_prob)
            t_cold = (rng.uniform(fl.cold_start_lo, fl.cold_start_hi)
                      if cold else 0.0)
            if cold:
                stats["cold"] += 1
                stats["cold_delays"].append(float(t_cold))
            elif self.pool is not None:
                stats["warm"] += 1
            # S3 input GET transients: seeded retries delay the run start
            # (and bill extra GETs via run_phase).
            t_get = 0.0
            if (s3 is not None and s3.get_fail_prob > 0.0
                    and s3.t_start <= t0 + t < s3.t_end):
                for i in range(s3.max_tries):
                    if frng.random() >= s3.get_fail_prob:
                        break
                    t_get += s3.retry_delay * (2.0 ** i)
                    fstats["s3_get_retries"] += 1
            run = duration(w, attempt)
            start = t + t_cold + t_get
            # What kills this attempt, if anything — the earliest death
            # wins.  Under fail_open the final attempt is immune.
            final = fl.fail_open and attempt >= fl.max_retries
            t_die = math.inf
            cause = None
            oomspec = fp.oom if fp is not None else None
            if (not final and oomspec is not None
                    and working_set_gb is not None
                    and eff_memory_gb * mem_scale[w] < working_set_gb):
                t_die = start + oomspec.kill_at_fraction * run
                cause = "oom"
            b = fp.burst if fp is not None else None
            if (not final and b is not None and b.kill_fraction > 0.0
                    and t0 + start < b.t_end
                    and t0 + start + run > b.t_start):
                fstats["burst_exposed"] += 1
                if frng.random() < b.kill_fraction:
                    # The whole zone goes down at t_start: every attempt
                    # already running dies at that instant, later launches
                    # die on arrival — correlated, not i.i.d.
                    t_hit = max(start, b.t_start - t0)
                    if t_hit < t_die:
                        t_die, cause = t_hit, "burst"
            if (not final and fl.failure_rate > 0.0
                    and rng.random() < fl.failure_rate):
                t_fail = start + rng.uniform(0.05, 0.95) * run
                if t_fail < t_die:
                    t_die, cause = t_fail, "fail"
            if cause is not None:
                attempts.append(
                    (t, t_die) if mem_scale[w] == 1.0
                    else (t, t_die, float(mem_scale[w])))
                if cause == "fail":
                    stats["retries"] += 1
                elif cause == "burst":
                    fstats["burst_kills"] += 1
                else:
                    fstats["oom_kills"] += 1
                if self.pool is not None:
                    # A function error does not tear the container down.
                    self.pool.release(t0 + t_die)
                if th is not None:
                    heapq.heappush(running, t_die)
                    fstats["peak_concurrency"] = max(
                        fstats["peak_concurrency"], len(running))
                if attempt < fl.max_retries:
                    if cause == "oom" and oomspec.escalate:
                        # Retry at doubled memory (billed at that size).
                        mem_scale[w] = min(
                            mem_scale[w] * 2.0,
                            max(1.0, oomspec.max_memory_gb / eff_memory_gb))
                        fstats["oom_escalations"] += 1
                    heapq.heappush(events, (t_die + fl.retry_backoff, seq,
                                            w, attempt + 1, 0))
                    seq += 1
                else:
                    # Retry budget truly exhausted (fail_open=False): the
                    # result never arrives; every attempt above billed.
                    stats["exhausted"] += 1
            else:
                end = start + run
                # S3 output PUT transients: the worker lingers retrying
                # (billed for the longer run + the extra PUTs).
                if (s3 is not None and s3.put_fail_prob > 0.0
                        and s3.t_start <= t0 + end < s3.t_end):
                    for i in range(s3.max_tries):
                        if frng.random() >= s3.put_fail_prob:
                            break
                        end += s3.retry_delay * (2.0 ** i)
                        fstats["s3_put_retries"] += 1
                attempts.append(
                    (t, end) if mem_scale[w] == 1.0
                    else (t, end, float(mem_scale[w])))
                successes += 1
                done[w] = end
                if self.pool is not None:
                    self.pool.release(t0 + end)
                if th is not None:
                    heapq.heappush(running, end)
                    fstats["peak_concurrency"] = max(
                        fstats["peak_concurrency"], len(running))
        return done, attempts, successes, stats

    def run_phase(self, key: torch.Tensor, num_workers: int, *,
                  work_per_worker: float = 1.0,
                  flops_per_worker: Optional[float] = None,
                  policy: str = "wait_all", k: Optional[int] = None,
                  comm_units: float = 0.0,
                  decodable: Optional[Callable[[np.ndarray], bool]] = None,
                  not_before: Optional[float] = None,
                  memory_gb: Optional[float] = None,
                  working_set_gb: Optional[float] = None,
                  phase_name: Optional[str] = None,
                  phase_deps: Tuple[str, ...] = ()
                  ) -> Tuple[float, np.ndarray]:
        """Simulate one distributed phase; returns (elapsed, finished_mask).

        ``elapsed`` includes the master-side communication charge.
        ``not_before`` (absolute simulated seconds) launches the phase
        earlier than the current clock, overlapping whatever advanced the
        clock since; the clock then moves to ``max(now, not_before +
        elapsed)``.  ``memory_gb`` bills this phase at its own Lambda size.
        ``working_set_gb`` is the phase's true per-worker working set: an
        attached ``OomSpec`` kills attempts sized below it.  ``phase_name``
        names the phase in a ``PhaseExhaustedError``; ``phase_deps`` feeds
        the reference's telemetry and is accepted unused."""
        if self.replay is not None:
            elapsed, mask, entry, advance, row = self.replay.next_phase(
                policy=policy, num_workers=num_workers)
            self.seconds += advance
            self.ledger.add(entry)
            corrupted_hex = (row.get("faults") or {}).get("corrupted")
            self.last_corruption = (
                None if corrupted_hex is None
                else _trace._mask_from_hex(corrupted_hex, num_workers))
            self._phase_idx += 1
            if row.get("raised"):
                # The recording exhausted here; re-raise so the replayed
                # algorithm takes the same degradation path.
                raise PhaseExhaustedError(
                    phase_name or self._phase_idx - 1, num_workers,
                    mask, elapsed)
            return elapsed, mask

        rng = _np_rng(key)
        fp = self.faults
        frng = None
        if fp is not None and fp.active():
            # Dedicated fault stream: folded from the phase key AND the
            # plan seed, so injected chaos is reproducible per phase and
            # the base lifecycle stream is exactly the plan-less one.
            frng = _np_rng(prng.fold_in(key, 99991 + fp.seed))
        t0 = float(self.seconds if not_before is None else not_before)
        pool_killed = 0
        if (fp is not None and fp.pool_death is not None
                and self.pool is not None and not self._pool_death_done
                and t0 >= fp.pool_death.t):
            # The provider reclaimed a fraction of the idle containers;
            # applied once, at the first phase launching at or after t.
            pool_killed = self.pool.cull(
                fp.pool_death.fraction,
                np.random.default_rng(fp.seed + 0xDEAD))
            self._pool_death_done = True
        eff_memory_gb = float(self.cost_model.memory_gb
                              if memory_gb is None else memory_gb)
        done, attempts, successes, stats = self._lifecycle(
            key, rng, num_workers, work_per_worker, flops_per_worker, t0,
            frng=frng, eff_memory_gb=eff_memory_gb,
            working_set_gb=working_set_gb)
        fstats = stats.get("faults")
        if fstats is not None:
            fstats["pool_killed"] = pool_killed

        relaunch_cache: dict = {}

        def sample_relaunch() -> np.ndarray:
            # Duplicates live in the same fleet as originals: they can hit
            # cold containers and they can die (duration inf — the original
            # copy then wins; min() in the policy handles it).
            if "r" not in relaunch_cache:
                fl = self.fleet
                run = self.model.sample_times(
                    prng.fold_in(key, 7777), num_workers, work_per_worker,
                    flops_per_worker).numpy().astype(np.float64)
                if fl.cold_start_prob > 0.0:
                    cold = rng.random(num_workers) < fl.cold_start_prob
                    run = run + cold * rng.uniform(
                        fl.cold_start_lo, fl.cold_start_hi, num_workers)
                if fl.failure_rate > 0.0:
                    run = np.where(rng.random(num_workers) < fl.failure_rate,
                                   np.inf, run)
                if frng is not None:
                    # Relaunches share the injected chaos: a burst window
                    # covering this phase kills duplicates with the same
                    # correlated coin, and an active concurrency cap
                    # serializes their admission (each batch of
                    # ``max_concurrent`` duplicates waits one more backoff
                    # + jitter step).  Extra draws come from the fault
                    # stream only — the plan-less stream stays identical.
                    b = fp.burst
                    if (b is not None and b.kill_fraction > 0.0
                            and b.t_start <= t0 < b.t_end):
                        run = np.where(
                            frng.random(num_workers) < b.kill_fraction,
                            np.inf, run)
                    th = fp.throttle
                    if th is not None and th.t_start <= t0 < th.t_end:
                        waves = np.arange(num_workers) // th.max_concurrent
                        run = run + waves * (
                            th.backoff
                            + frng.uniform(0.0, th.jitter, num_workers))
                relaunch_cache["r"] = run
            return relaunch_cache["r"]

        ctx = _policies.PhaseContext(
            k=k, watch_fraction=self.fleet.watch_fraction,
            hedge_quantile=self.fleet.hedge_quantile,
            decodable=decodable, sample_relaunch=sample_relaunch)
        outcome = _policies.get_policy(policy)(done, ctx)

        raised = not math.isfinite(float(outcome.elapsed))
        if raised:
            # The policy cannot terminate without an exhausted worker's
            # result.  The master stops at the last lifecycle event it
            # observed; everything that ran still bills, the partial phase
            # is recorded, and a typed error surfaces the survivors.
            mask = np.isfinite(done)
            elapsed = float(max((a[1] for a in attempts), default=0.0))
            extra_attempts = [e for e in outcome.extra_attempts
                              if math.isfinite(e[1])]
        else:
            mask = np.asarray(outcome.mask, dtype=bool)
            elapsed = float(outcome.elapsed
                            + self.model.comm_per_unit * comm_units)
            extra_attempts = list(outcome.extra_attempts)
        all_attempts = attempts + extra_attempts
        cost_model = (self.cost_model if memory_gb is None else
                      dataclasses.replace(self.cost_model,
                                          memory_gb=float(memory_gb)))
        entry = bill_phase(cost_model, all_attempts,
                           successes + outcome.extra_successes,
                           comm_units)
        if fstats is not None:
            # Throttle rejections bill control-plane invocations; S3
            # transients bill the extra ops their retries issued.
            entry.invocations += float(fstats["throttled"])
            entry.s3_gets += float(fstats["s3_get_retries"])
            entry.s3_puts += float(fstats["s3_put_retries"])
        if cost_model.billing == "reserved":
            # Fixed cluster: every node bills the phase's wall-clock
            # (idle-behind-the-straggler time included), not its own work.
            entry.gb_seconds = (cost_model.memory_gb * num_workers
                                * elapsed)
        if not_before is None:
            advance = elapsed   # not (now + e) - now: that rounds off a ULP
        else:
            advance = max(0.0, float(not_before) + elapsed - self.seconds)
        self.seconds += advance
        self.ledger.add(entry)
        corrupted = None
        if fp is not None and fp.corruption is not None:
            c = fp.corruption
            u = frng.random(num_workers)
            abs_done = t0 + done
            corrupted = (np.isfinite(done) & (abs_done >= c.t_start)
                         & (abs_done < c.t_end) & (u < c.prob))
        self.last_corruption = corrupted
        if self.recorder is not None:
            # free_at, not len(): lazy TTL expiry means the raw pool still
            # holds containers no launch at the current clock could use.
            pool_free = (self.pool.free_at(self.seconds)
                         if self.pool is not None else None)
            self.recorder.record_phase(
                self._phase_idx, policy=policy, num_workers=num_workers,
                k=k, elapsed=elapsed, mask=mask,
                entry=entry, worker_times=done, advance=advance,
                memory_gb=None if memory_gb is None else float(memory_gb),
                stats=stats, pool_free=pool_free, corrupted=corrupted,
                raised=raised)
        self._phase_idx += 1
        if raised:
            raise PhaseExhaustedError(
                phase_name or self._phase_idx - 1, num_workers, mask,
                elapsed)
        return elapsed, mask
