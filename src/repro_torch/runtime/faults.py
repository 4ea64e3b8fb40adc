"""Deterministic fault injection for the fleet engine (the chaos plane);
port of ``repro/runtime/faults.py``, host code with no tensors.

Six specs declare the ways a serverless fleet breaks, as data that
composes onto ``FleetEngine.run_phase`` deterministically:

  - ``BurstSpec``      - an "AZ event": attempts in flight during
    ``[t_start, t_end)`` die with probability ``kill_fraction``, from one
    seeded stream (correlated, not i.i.d.).
  - ``ThrottleSpec``   - a concurrency cap: a launch past ``max_concurrent``
    is rejected, billed as an invocation and re-queued after exponential
    backoff with jitter.
  - ``S3Spec``         - transient storage errors on each attempt's input
    GET and output PUT; each retry delays the attempt and bills an op.
  - ``OomSpec``        - an attempt whose Lambda size is below the phase's
    declared working set is OOM-killed at ``kill_at_fraction`` of its run;
    with ``escalate`` the retry doubles the memory.
  - ``PoolDeathSpec``  - at the first phase launching at or after ``t`` a
    seeded ``fraction`` of the warm pool's idle containers is culled.
  - ``CorruptionSpec`` - a completed worker's result is silently wrong with
    probability ``prob`` inside the window; the engine only marks it
    (``last_corruption``); the Newton loop's coded mat-vecs rebuild what
    the master received and decode around it by parity checks.

A ``FaultPlan`` bundles any subset plus a ``seed``.  All fault randomness
comes from a generator folded from the phase key and that seed, so a run
without a plan draws exactly the stream it drew before.  Named scenarios
are factories in a registry (``get_scenario("az_burst")``).
``PhaseExhaustedError`` is the typed surface of a retry budget that truly
ran out (``FleetConfig.fail_open=False``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class BurstSpec:
    """Correlated burst ("AZ event"): in-flight attempts in the window die."""

    t_start: float = 0.0           # absolute simulated seconds
    t_end: float = math.inf
    kill_fraction: float = 0.5     # P[an exposed attempt dies]

    def __post_init__(self):
        if not 0.0 <= self.kill_fraction <= 1.0:
            raise ValueError(
                f"kill_fraction must be in [0, 1], got {self.kill_fraction}")
        if self.t_end < self.t_start:
            raise ValueError("burst window must have t_end >= t_start")


@dataclasses.dataclass(frozen=True)
class ThrottleSpec:
    """Concurrency cap with exponential backoff + jitter on rejection."""

    max_concurrent: int = 8
    backoff: float = 0.05          # first rejection's base wait
    backoff_mult: float = 2.0      # exponential growth per consecutive try
    jitter: float = 0.02           # U[0, jitter) added to every wait
    t_start: float = 0.0
    t_end: float = math.inf

    def __post_init__(self):
        if self.max_concurrent < 1:
            raise ValueError(
                f"max_concurrent must be >= 1, got {self.max_concurrent}")


@dataclasses.dataclass(frozen=True)
class S3Spec:
    """Transient storage errors on per-attempt GETs and PUTs."""

    get_fail_prob: float = 0.0
    put_fail_prob: float = 0.0
    retry_delay: float = 0.02      # first retry's delay; doubles per retry
    max_tries: int = 5             # retries per op (success forced after)
    t_start: float = 0.0
    t_end: float = math.inf

    def __post_init__(self):
        for p in (self.get_fail_prob, self.put_fail_prob):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"S3 failure probs must be in [0,1], got {p}")


@dataclasses.dataclass(frozen=True)
class OomSpec:
    """OOM kill when effective memory < the phase's declared working set."""

    kill_at_fraction: float = 0.9  # fraction of the run before the kill
    escalate: bool = True          # retry at doubled memory (billed)
    max_memory_gb: float = 10.0    # Lambda's memory ceiling


@dataclasses.dataclass(frozen=True)
class PoolDeathSpec:
    """Cull a seeded fraction of idle warm containers at time ``t``."""

    t: float = 0.0
    fraction: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"pool-death fraction must be in [0, 1], got {self.fraction}")


@dataclasses.dataclass(frozen=True)
class CorruptionSpec:
    """Silent result corruption on completed workers inside the window."""

    prob: float = 0.05
    t_start: float = 0.0
    t_end: float = math.inf

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"corruption prob must be in [0, 1], got {self.prob}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Any subset of fault scenarios, plus the seed their draws fold in."""

    burst: Optional[BurstSpec] = None
    throttle: Optional[ThrottleSpec] = None
    s3: Optional[S3Spec] = None
    oom: Optional[OomSpec] = None
    pool_death: Optional[PoolDeathSpec] = None
    corruption: Optional[CorruptionSpec] = None
    seed: int = 0

    def active(self) -> bool:
        return any(s is not None for s in (
            self.burst, self.throttle, self.s3, self.oom, self.pool_death,
            self.corruption))

    def events(self) -> list:
        """Declared fault windows as typed, JSON-ready dicts.

        The incident engine reads these as ground truth
        (``obs.incident``): each dict names the cause the window
        would produce, its ``[t_start, t_end)`` extent in absolute
        simulated seconds (``t_end: None`` for an open window — OOM and
        pool death have effects that persist to the end of the run), and
        a human-readable knob summary.  Deterministic: pure function of
        the plan's specs, sorted by (t_start, cause).
        """
        out = []

        def win(cause: str, t0: float, t1: float, detail: str) -> None:
            out.append({"cause": cause, "t_start": float(t0),
                        "t_end": None if math.isinf(t1) else float(t1),
                        "detail": detail})

        if self.burst is not None:
            b = self.burst
            win("az_burst", b.t_start, b.t_end,
                f"kill_fraction={b.kill_fraction}")
        if self.throttle is not None:
            th = self.throttle
            win("throttle", th.t_start, th.t_end,
                f"max_concurrent={th.max_concurrent}")
        if self.s3 is not None:
            s = self.s3
            win("s3_transient", s.t_start, s.t_end,
                f"get_fail={s.get_fail_prob},put_fail={s.put_fail_prob}")
        if self.oom is not None:
            o = self.oom
            win("oom", 0.0, math.inf,
                f"kill_at={o.kill_at_fraction},escalate={o.escalate}")
        if self.pool_death is not None:
            p = self.pool_death
            win("pool_death", p.t, math.inf, f"fraction={p.fraction}")
        if self.corruption is not None:
            c = self.corruption
            win("corruption", c.t_start, c.t_end, f"prob={c.prob}")
        return sorted(out, key=lambda e: (e["t_start"], e["cause"]))


class PhaseExhaustedError(RuntimeError):
    """A phase's retry budget truly ran out (``fail_open=False``).

    Raised by ``FleetEngine.run_phase`` *after* billing every attempt,
    recording the partial phase row, and advancing the clock to the last
    observed lifecycle event — so a caller that catches it resumes on a
    consistent (seconds, dollars) timeline.  ``mask`` is the boolean
    finite-survivor mask (workers whose results did land)."""

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


# ----------------------------------------------------------------- registry
ScenarioFactory = Callable[..., FaultPlan]

_SCENARIOS: Dict[str, ScenarioFactory] = {}


def register_scenario(name: str) -> Callable[[ScenarioFactory],
                                             ScenarioFactory]:
    def deco(fn: ScenarioFactory) -> ScenarioFactory:
        if name in _SCENARIOS and _SCENARIOS[name] is not fn:
            raise ValueError(f"scenario {name!r} already registered")
        _SCENARIOS[name] = fn
        return fn
    return deco


def get_scenario(name: str, **knobs) -> FaultPlan:
    try:
        factory = _SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: {available_scenarios()}"
        ) from None
    return factory(**knobs)


def available_scenarios() -> list:
    return sorted(_SCENARIOS)


@register_scenario("az_burst")
def az_burst(t_start: float = 0.5, t_end: float = 2.0,
             kill_fraction: float = 0.6, seed: int = 0) -> FaultPlan:
    return FaultPlan(burst=BurstSpec(t_start=t_start, t_end=t_end,
                                     kill_fraction=kill_fraction), seed=seed)


@register_scenario("throttle")
def throttle(max_concurrent: int = 8, backoff: float = 0.05,
             backoff_mult: float = 2.0, jitter: float = 0.02,
             t_start: float = 0.0, t_end: float = math.inf,
             seed: int = 0) -> FaultPlan:
    return FaultPlan(throttle=ThrottleSpec(
        max_concurrent=max_concurrent, backoff=backoff,
        backoff_mult=backoff_mult, jitter=jitter, t_start=t_start,
        t_end=t_end), seed=seed)


@register_scenario("s3_transient")
def s3_transient(get_fail_prob: float = 0.3, put_fail_prob: float = 0.15,
                 retry_delay: float = 0.02, max_tries: int = 5,
                 seed: int = 0) -> FaultPlan:
    return FaultPlan(s3=S3Spec(get_fail_prob=get_fail_prob,
                               put_fail_prob=put_fail_prob,
                               retry_delay=retry_delay,
                               max_tries=max_tries), seed=seed)


@register_scenario("oom")
def oom(kill_at_fraction: float = 0.9, escalate: bool = True,
        max_memory_gb: float = 10.0, seed: int = 0) -> FaultPlan:
    return FaultPlan(oom=OomSpec(kill_at_fraction=kill_at_fraction,
                                 escalate=escalate,
                                 max_memory_gb=max_memory_gb), seed=seed)


@register_scenario("pool_death")
def pool_death(t: float = 1.0, fraction: float = 0.75,
               seed: int = 0) -> FaultPlan:
    return FaultPlan(pool_death=PoolDeathSpec(t=t, fraction=fraction),
                     seed=seed)


@register_scenario("corruption")
def corruption(prob: float = 0.1, t_start: float = 0.0,
               t_end: float = math.inf, seed: int = 0) -> FaultPlan:
    return FaultPlan(corruption=CorruptionSpec(prob=prob, t_start=t_start,
                                               t_end=t_end), seed=seed)
