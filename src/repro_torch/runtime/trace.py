"""Fleet trace record / replay and empirical calibration; port of
``repro/runtime/trace.py``, host code with no tensors.

A trace is a JSONL phase log with the reference's schema, row for row, so
a trace recorded by either package replays in the other:

  {"kind": "phase", "phase": 0, "policy": "k_of_n", "workers": 24, "k": 20,
   "elapsed": 1.23, "mask": "fffff0", "gb_seconds": 93.1, "invocations": 31,
   "s3_puts": 25.0, "s3_gets": 63.0, "worker_times": [...optional...]}
  {"kind": "charge", "phase": 1, "elapsed": 0.57}

``mask`` is the finished-worker bitmask, big-endian bit-packed and hex
(worker 0 = MSB of the first byte).  Floats go through ``json`` (``repr``),
which round-trips IEEE doubles, so a replayed run reproduces bit-identical
``(seconds, dollars)``.  Additive fields, each present only when it
applies: ``advance`` (an overlapped phase), ``memory_gb`` (a per-phase
Lambda size), ``pool`` (warm/cold/free with a ``WarmPool``), ``retries``
and ``cold_delays`` (``TraceRecorder(lifecycle=True)``), ``faults`` (the
counts a ``FaultPlan`` injected, ``corrupted`` as a hex mask),
``exhausted``, ``raised`` (replay re-raises ``PhaseExhaustedError``) and
``provisioned_gb_seconds``.

``calibrate_from_trace``, ``calibrate_fleet_from_trace`` and
``calibrate_faults_from_trace`` fit a ``StragglerModel``, a ``FleetConfig``
and a ``FaultPlan`` back from a recorded trace.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.straggler import StragglerModel
from repro_torch.runtime.cost import CostLedger


def _mask_to_hex(mask: np.ndarray) -> str:
    return np.packbits(np.asarray(mask, dtype=np.uint8)).tobytes().hex()


def _mask_from_hex(s: str, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(s), dtype=np.uint8))
    return bits[:n].astype(bool)


@dataclasses.dataclass
class TraceRecorder:
    """Collects phase rows; ``dump`` writes JSONL.

    ``lifecycle=True`` additionally records each phase's failure-retry
    count and drawn cold-start delays (schema v2) — the raw material for
    ``calibrate_fleet_from_trace``.  Off by default so default recordings
    stay byte-identical to pre-v2 traces."""

    worker_times: bool = False
    lifecycle: bool = False
    rows: List[dict] = dataclasses.field(default_factory=list)

    def record_phase(self, phase: int, *, policy: str, num_workers: int,
                     k: Optional[int], elapsed: float, mask: np.ndarray,
                     entry: CostLedger,
                     worker_times: Optional[np.ndarray] = None,
                     advance: Optional[float] = None,
                     memory_gb: Optional[float] = None,
                     stats: Optional[dict] = None,
                     pool_free: Optional[int] = None,
                     corrupted: Optional[np.ndarray] = None,
                     raised: bool = False) -> None:
        row = {"kind": "phase", "phase": phase, "policy": policy,
               "workers": int(num_workers), "k": k,
               "elapsed": float(elapsed), "mask": _mask_to_hex(mask)}
        if advance is not None and advance != elapsed:
            # Overlapped phase (run_phase not_before=...): the clock moved
            # by less than the phase duration.  Absent for sequential
            # phases so pre-overlap traces replay unchanged.
            row["advance"] = float(advance)
        if memory_gb is not None:
            row["memory_gb"] = float(memory_gb)
        if pool_free is not None:
            # Pool attached: warm/cold split of this phase's lifecycle
            # attempts and the free-container count after the phase.
            row["pool"] = {"warm": int(stats["warm"]) if stats else 0,
                           "cold": int(stats["cold"]) if stats else 0,
                           "free": int(pool_free)}
        if self.lifecycle and stats is not None:
            row["retries"] = int(stats["retries"])
            row["cold_delays"] = [float(t) for t in stats["cold_delays"]]
        # Schema v3: injected-event record, keys only when events happened
        # (a plan-less run writes none of this — byte-identical to v2).
        faults = dict(stats.get("faults") or {}) if stats else {}
        waits = faults.pop("throttle_waits", None)
        frow = {kk: int(v) for kk, v in faults.items() if v}
        if self.lifecycle and waits:
            frow["throttle_waits"] = [float(t) for t in waits]
        if corrupted is not None and corrupted.any():
            frow["corrupted"] = _mask_to_hex(corrupted)
        if frow:
            row["faults"] = frow
        if stats and stats.get("exhausted"):
            row["exhausted"] = int(stats["exhausted"])
        if raised:
            row["raised"] = True
        row.update(entry.as_dict())
        if self.worker_times and worker_times is not None:
            row["worker_times"] = [float(t) for t in worker_times]
        self.rows.append(row)

    def record_charge(self, phase: int, elapsed: float) -> None:
        self.rows.append({"kind": "charge", "phase": phase,
                          "elapsed": float(elapsed)})

    def dump(self, path) -> None:
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")


class TraceReplayer:
    """Replays a recorded trace row-by-row; the engine consumes one row per
    phase()/charge() call and re-applies the recorded time and cost, so a
    replayed run is bit-identical to the recording."""

    def __init__(self, rows: List[dict]):
        self.rows = list(rows)
        self._i = 0

    def _next(self, kind: str) -> dict:
        if self._i >= len(self.rows):
            raise ValueError(f"trace exhausted at row {self._i} "
                             f"(wanted a {kind!r} row)")
        row = self.rows[self._i]
        if row["kind"] != kind:
            raise ValueError(f"trace row {self._i} is {row['kind']!r}, "
                             f"run wanted {kind!r} — phase structure drifted")
        self._i += 1
        return row

    def next_phase(self, *, policy: str, num_workers: int
                   ) -> Tuple[float, np.ndarray, CostLedger, float, dict]:
        row = self._next("phase")
        if row["policy"] != policy or row["workers"] != num_workers:
            raise ValueError(
                f"trace row {self._i - 1} recorded "
                f"({row['policy']!r}, {row['workers']} workers), run asked "
                f"({policy!r}, {num_workers}) — not the same schedule")
        entry = CostLedger(gb_seconds=row["gb_seconds"],
                           invocations=row["invocations"],
                           s3_puts=row["s3_puts"], s3_gets=row["s3_gets"],
                           # Schema v4 (additive): idle provisioned-
                           # concurrency GB-seconds, absent pre-tenancy.
                           provisioned_gb_seconds=row.get(
                               "provisioned_gb_seconds", 0.0))
        return (row["elapsed"], _mask_from_hex(row["mask"], num_workers),
                entry, row.get("advance", row["elapsed"]), row)

    def next_charge(self) -> float:
        return self._next("charge")["elapsed"]


def load_trace(path) -> TraceReplayer:
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return TraceReplayer(rows)


# --------------------------------------------------------------- calibration
def calibrate_from_times(times, tail_cut: float = 1.25) -> StragglerModel:
    """Fit a StragglerModel to empirical per-worker job times (Fig. 1 shape).

    Workers above ``tail_cut`` x median are stragglers: their fraction gives
    ``p_tail`` and their span the tail bounds; the body's log-spread around
    the median gives ``body_sigma``.  Invocation overhead is not separable
    from a bare completion-time histogram, so it calibrates to 0.
    """
    t = np.asarray(times, dtype=np.float64).ravel()
    if t.size == 0 or not np.all(t > 0):
        raise ValueError("calibration needs positive per-worker times")
    med = float(np.median(t))
    body = t[t <= tail_cut * med]
    tail = t[t > tail_cut * med]
    sigma = float(np.std(np.log(body / med))) if body.size > 1 else 0.05
    p_tail = float(tail.size / t.size)
    if tail.size:
        tail_lo = max(0.05, float(tail.min() / med - 1.0))
        tail_hi = max(tail_lo + 0.05, float(tail.max() / med - 1.0))
    else:
        tail_lo, tail_hi = 0.3, 1.5
    return StragglerModel(base_time=med, body_sigma=max(sigma, 1e-3),
                          p_tail=p_tail, tail_lo=tail_lo, tail_hi=tail_hi,
                          invoke_overhead=0.0)


def calibrate_from_trace(path, tail_cut: float = 1.25) -> StragglerModel:
    """Pool every recorded phase's ``worker_times`` (normalized per phase so
    phases with different work mix) and fit the pooled shape."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    pooled, medians = [], []
    for row in rows:
        wt = row.get("worker_times")
        if not wt:
            continue
        wt = np.asarray(wt, dtype=np.float64)
        med = float(np.median(wt))
        if med > 0:
            pooled.append(wt / med)
            medians.append(med)
    if not pooled:
        raise ValueError(f"no worker_times rows in {path}; record with "
                         "TraceRecorder(worker_times=True)")
    scale = float(np.mean(medians))   # representative per-phase base time
    return calibrate_from_times(np.concatenate(pooled) * scale,
                                tail_cut=tail_cut)


def calibrate_fleet_from_trace(path) -> "FleetConfig":
    """Fit a ``FleetConfig`` (failure rate + cold-start statistics) to a
    schema-v2 lifecycle trace (``TraceRecorder(lifecycle=True)``).

    Estimators, over all phase rows:

      - ``failure_rate``: retries / lifecycle launches.  Each lifecycle
        attempt below the retry cap fails independently with rate p, so
        launches per worker are geometric and failures/launches -> p
        (the retry-cap truncation bias is O(p^max_retries)).
      - ``cold_start_prob``: cold starts / lifecycle launches — the i.i.d.
        reading of the trace; a warm-pool trace yields the *effective*
        cold rate its schedule produced, which is the number a pool-less
        simulation of the same workload should use.
      - ``cold_start_lo`` / ``hi``: min / max of the recorded cold delays
        (consistent for the U[lo, hi] the engine draws from).

    The closing loop: a synthetic "public Lambda trace" recorded under a
    known fleet round-trips to that fleet's parameters (see
    ``tests/fixtures/lambda_trace_synthetic.jsonl``).
    """
    from repro_torch.runtime.engine import FleetConfig   # engine does not import us
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    phase_rows = [r for r in rows if r.get("kind") == "phase"]
    if not any("retries" in r for r in phase_rows):
        raise ValueError(
            f"no lifecycle rows in {path}; record with "
            "TraceRecorder(lifecycle=True)")
    launches = 0
    retries = 0
    delays: list = []
    for r in phase_rows:
        if "retries" not in r:
            continue
        retries += int(r["retries"])
        launches += int(r["workers"]) + int(r["retries"])
        delays.extend(r.get("cold_delays", ()))
    if launches == 0:
        raise ValueError(f"lifecycle rows in {path} contain no launches")
    failure_rate = retries / launches
    cold_prob = len(delays) / launches
    if delays:
        lo, hi = float(min(delays)), float(max(delays))
        if hi <= lo:
            hi = lo + 1e-6
    else:
        dflt = FleetConfig()
        lo, hi = dflt.cold_start_lo, dflt.cold_start_hi
    return FleetConfig(failure_rate=failure_rate, cold_start_prob=cold_prob,
                       cold_start_lo=lo, cold_start_hi=hi)


def calibrate_faults_from_trace(path) -> "FaultPlan":
    """Fit a ``runtime.faults.FaultPlan`` to a schema-v3 fault trace.

    The inverse of injection, for the knobs a trace identifies:

      - burst ``kill_fraction``: burst kills / burst-exposed attempts —
        each exposed attempt flips the same seeded coin, so the ratio is
        the maximum-likelihood estimate of the coin.
      - throttle ``max_concurrent``: the max recorded ``peak_concurrency``
        over rows where rejections actually happened — a saturated
        admission heap sits exactly at the cap.
      - throttle ``backoff``: the smallest recorded wait (first-rejection
        waits are ``backoff + U[0, jitter)``, so the min over many waits
        converges on ``backoff`` from above; needs ``lifecycle=True``
        rows).
      - S3 ``get_fail_prob``: GET retries / (launches + GET retries) —
        every try fails independently, so failures over total tries is
        again the ML estimate.

    Windows and seeds are not identifiable from counts alone and come
    back as the estimators' all-time defaults.
    """
    from repro_torch.runtime.faults import (BurstSpec, FaultPlan, S3Spec,
                                      ThrottleSpec)
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    frows = [(r, r["faults"]) for r in rows
             if r.get("kind") == "phase" and r.get("faults")]
    if not frows:
        raise ValueError(f"no fault rows in {path}; record a run with a "
                         "FaultPlan attached")
    kills = sum(f.get("burst_kills", 0) for _, f in frows)
    exposed = sum(f.get("burst_exposed", 0) for _, f in frows)
    burst = (BurstSpec(kill_fraction=kills / exposed) if exposed else None)
    throttle = None
    peaks = [f["peak_concurrency"] for _, f in frows
             if f.get("throttled") and f.get("peak_concurrency")]
    if peaks:
        waits = [w for _, f in frows for w in f.get("throttle_waits", ())]
        kw = {"max_concurrent": int(max(peaks))}
        if waits:
            kw["backoff"] = float(min(waits))
        throttle = ThrottleSpec(**kw)
    s3 = None
    get_retries = sum(f.get("s3_get_retries", 0) for _, f in frows)
    if get_retries:
        launches = sum(int(r["workers"]) + int(r.get("retries", 0))
                       for r, _ in frows)
        s3 = S3Spec(get_fail_prob=get_retries / (launches + get_retries))
    return FaultPlan(burst=burst, throttle=throttle, s3=s3)
