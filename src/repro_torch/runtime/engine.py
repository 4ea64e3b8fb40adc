"""Discrete-event serverless fleet engine; port of ``repro/runtime/engine.py``.

``FleetEngine`` is the substrate every optimizer is scored on.  One
``run_phase`` call simulates one distributed round:

  1. Each worker is launched at t=0.  An attempt may hit a **cold start**
     (probability ``cold_start_prob``, extra U[lo, hi] delay), then runs for
     a duration drawn from the ``StragglerModel``.
  2. An attempt may **fail** mid-run (probability ``failure_rate``); the
     master relaunches it after ``retry_backoff``.  Under ``fail_open`` the
     attempt at index ``max_retries`` always succeeds; otherwise a worker
     whose last attempt dies is exhausted and the phase may raise
     ``PhaseExhaustedError``.
  3. The phase's termination policy (``runtime.policies``) decides the
     master's wait and the result mask, possibly adding relaunches.
  4. Every attempt is billed through the ``CostModel``.

The fleet is host-side numpy, as in the reference: run durations come from
``model.sample_times`` under keys folded from the phase key, and lifecycle
coin flips from a numpy ``Generator`` seeded with the key's two uint32
words, so identical keys give identical ``(seconds, dollars)`` in both
packages.  Trace record/replay, warm pools, fault plans and live telemetry
wait for ROADMAP Queue 1 items 6 and 10; passing them raises.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.runtime import policies as _policies
from repro_torch.runtime.cost import CostLedger, CostModel, bill_phase
from repro_torch.runtime.faults import PhaseExhaustedError


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
    fail_open: bool = True


def _np_rng(key: torch.Tensor) -> np.random.Generator:
    """Numpy generator seeded with the key's two uint32 words."""
    return np.random.default_rng(prng.key_data(key).ravel().tolist())


class FleetEngine:
    """Accumulates simulated seconds and dollars across phases."""

    def __init__(self, model, fleet: Optional[FleetConfig] = None,
                 cost: Optional[CostModel] = None,
                 recorder=None, replay=None, pool=None, telemetry=None,
                 faults=None):
        for name, value in (("recorder", recorder), ("replay", replay),
                            ("pool", pool), ("faults", faults)):
            if value is not None:
                raise NotImplementedError(
                    f"FleetEngine({name}=...) is not ported yet (ROADMAP "
                    "Queue 1 item 6)")
        if telemetry is not None:
            raise NotImplementedError(
                "live telemetry is not ported yet (ROADMAP Queue 1 item 10)")
        self.model = model
        self.fleet = fleet if fleet is not None else FleetConfig()
        self.cost_model = cost if cost is not None else CostModel()
        self.ledger = CostLedger()
        self.seconds = 0.0

    @property
    def dollars(self) -> float:
        return self.ledger.dollars(self.cost_model)

    def _lifecycle(self, key: torch.Tensor, rng: np.random.Generator,
                   num_workers: int, work_per_worker: float,
                   flops_per_worker: Optional[float]
                   ) -> Tuple[np.ndarray, List[tuple], int]:
        """Event-driven per-worker lifecycle: cold start -> running -> done
        | failed-with-retry | exhausted.  Returns (completion times, billed
        (launch, end) attempts, successes)."""
        fl = self.fleet
        round_times: dict = {}

        def duration(worker: int, attempt: int) -> float:
            # One sample round per retry wave, lazily.
            if attempt not in round_times:
                k = prng.fold_in(key, attempt)
                round_times[attempt] = self.model.sample_times(
                    k, num_workers, work_per_worker,
                    flops_per_worker).numpy().astype(np.float64)
            return float(round_times[attempt][worker])

        done = np.full(num_workers, np.inf)
        attempts: List[tuple] = []
        successes = 0
        events = [(0.0, w, w, 0) for w in range(num_workers)]
        heapq.heapify(events)
        seq = num_workers
        while events:
            t, _, w, attempt = heapq.heappop(events)
            cold = fl.cold_start_prob > 0.0 and rng.random() < fl.cold_start_prob
            t_cold = rng.uniform(fl.cold_start_lo, fl.cold_start_hi) if cold else 0.0
            run = duration(w, attempt)
            start = t + t_cold
            final = fl.fail_open and attempt >= fl.max_retries
            if (not final and fl.failure_rate > 0.0
                    and rng.random() < fl.failure_rate):
                t_die = start + rng.uniform(0.05, 0.95) * run
                attempts.append((t, t_die))
                if attempt < fl.max_retries:
                    heapq.heappush(events, (t_die + fl.retry_backoff, seq, w,
                                            attempt + 1))
                    seq += 1
                continue
            end = start + run
            attempts.append((t, end))
            successes += 1
            done[w] = end
        return done, attempts, successes

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
        ``working_set_gb``, ``phase_name`` and ``phase_deps`` feed the fault
        plane and telemetry of the reference and are accepted unused."""
        rng = _np_rng(key)
        done, attempts, successes = self._lifecycle(
            key, rng, num_workers, work_per_worker, flops_per_worker)

        relaunch_cache: dict = {}

        def sample_relaunch() -> np.ndarray:
            # Duplicates live in the same fleet as originals: they can hit
            # cold containers and they can die (duration inf).
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
            # result: the master stops at the last lifecycle event, every
            # attempt still bills.
            mask = np.isfinite(done)
            elapsed = float(max((a[1] for a in attempts), default=0.0))
            extra_attempts = [e for e in outcome.extra_attempts
                              if math.isfinite(e[1])]
        else:
            mask = np.asarray(outcome.mask, dtype=bool)
            elapsed = float(outcome.elapsed
                            + self.model.comm_per_unit * comm_units)
            extra_attempts = list(outcome.extra_attempts)
        cost_model = (self.cost_model if memory_gb is None else
                      dataclasses.replace(self.cost_model,
                                          memory_gb=float(memory_gb)))
        entry = bill_phase(cost_model, attempts + extra_attempts,
                           successes + outcome.extra_successes, comm_units)
        if cost_model.billing == "reserved":
            # A fixed cluster bills every node for the phase's wall clock.
            entry.gb_seconds = cost_model.memory_gb * num_workers * elapsed
        if not_before is None:
            advance = elapsed   # not (now + e) - now: that rounds off a ULP
        else:
            advance = max(0.0, float(not_before) + elapsed - self.seconds)
        self.seconds += advance
        self.ledger.add(entry)
        if raised:
            raise PhaseExhaustedError(phase_name, num_workers, mask, elapsed)
        return elapsed, mask
