"""Online fleet/convergence health monitors over the live metric stream.

Bartan-Pilanci's distributed-sketching analyses (PAPERS.md) give exact
expected-error characterizations per sketch family, which makes
convergence health *predictable*: the MP-debias factor, CG iteration
counts, cost per iteration, and the straggler completion tail all have a
stationary regime under a healthy run.  Deviations — debias drift when
too many sketch blocks die, CG blowup on an ill-conditioned Hessian
estimate, a straggler-tail shift when the fleet degrades, a warm-pool
hit-rate collapse — are detectable anomalies, not noise.  This module
detects them online, as the metrics stream through the registry.

Two classical detectors, both streaming and O(1)-ish per sample:

  - ``RobustZScore`` — a rolling median/MAD window; a sample whose robust
    z-score against the *prior* window exceeds ``z`` fires.  Catches
    spikes (one pathological phase, one blown-up iteration cost).
  - ``Cusum`` — a two-sided CUSUM on samples standardized against a
    frozen baseline (the first ``min_samples`` observations): the
    classic small-persistent-shift detector.  Catches drift (a slowly
    degrading straggler tail, MP-debias creep as survivors thin out).

``HealthMonitors`` routes named metric streams to detector instances via
``Rule``s and attaches to a ``Telemetry`` as the registry's listener.
Everything here is **strictly observation-only**: detectors draw no
randomness, read no clock (alerts are stamped with the span tracer's
``last_time`` high-water mark), and never touch the simulation — golden
-trace replays stay bit-identical with monitors attached
(``tests/test_golden_trace.py`` pins this).  Alerts are emitted three
ways: appended to ``monitors.alerts``, dropped into the span tree as
zero-duration ``alert`` spans (so they sit next to the phase that
triggered them), and written to the JSONL export as ``kind: "alert"``
rows that ``make_report --trace`` tabulates.

Tuning (see obs/README.md for the full table): ``z`` / ``h`` up for
fewer, stronger alerts; ``min_samples`` up when the warm-up transient
(cold pools, first-iteration compilation) should not count as baseline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: Default scale floors: ``scale = max(raw, rel_floor * |center|,
#: abs_floor)``.  Two jobs in one clamp: a deterministic (zero-variance)
#: baseline still scores instead of dividing by zero, and — more
#: important operationally — a stream that happens to be statistically
#: *tight* (per-worker completions cluster within ~1%) does not turn a
#: 3% wobble into a 7-sigma alert.  Detectors watching duration/cost
#: streams want ``rel_floor ~ 0.1`` (a deviation must be a meaningful
#: fraction of the stream's level to count); absolute-scale streams in
#: [0, 1] (debias factor, hit rate) want an ``abs_floor`` instead.
_REL_FLOOR = 1e-3
_ABS_FLOOR = 1e-12


def _scale_floor(scale: float, center: float, rel_floor: float,
                 abs_floor: float) -> float:
    return max(scale, rel_floor * abs(center), abs_floor)


@dataclasses.dataclass
class Alert:
    """One detected anomaly on one metric stream."""

    metric: str                 # registry name, e.g. "worker.completion_s"
    detector: str               # "zscore" | "cusum"
    t: float                    # simulated seconds (tracer high-water mark)
    value: float                # the sample that fired
    score: float                # robust z / CUSUM statistic at firing
    threshold: float            # the limit it crossed
    sample: int                 # 1-based index of the sample in its stream
    direction: str              # "high" | "low"

    def as_row(self) -> dict:
        return {"kind": "alert", "metric": self.metric,
                "detector": self.detector, "t": self.t,
                "value": self.value, "score": self.score,
                "threshold": self.threshold, "sample": self.sample,
                "direction": self.direction}


class RobustZScore:
    """Rolling median/MAD spike detector.

    A sample is scored against the window of the ``window`` samples
    *before* it (so a spike cannot mask itself), using the normalized MAD
    (1.4826 x) as the scale.  No alert until ``min_samples`` history
    exists.
    """

    name = "zscore"

    def __init__(self, window: int = 20, z: float = 4.0,
                 min_samples: int = 8, rel_floor: float = _REL_FLOOR,
                 abs_floor: float = _ABS_FLOOR):
        if min_samples < 2:
            raise ValueError("min_samples must be >= 2")
        self.window = int(window)
        self.z = float(z)
        self.min_samples = int(min_samples)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.buf: List[float] = []
        self.count = 0
        self.last_score = 0.0

    @staticmethod
    def _median(xs: Sequence[float]) -> float:
        ys = sorted(xs)
        n = len(ys)
        mid = n // 2
        return ys[mid] if n % 2 else 0.5 * (ys[mid - 1] + ys[mid])

    def update(self, x: float) -> Optional[Tuple[float, float, str]]:
        """Feed one sample; returns (score, threshold, direction) when it
        fires, else None.  The sample always joins the window afterwards."""
        x = float(x)
        fired = None
        self.count += 1
        if len(self.buf) >= self.min_samples:
            med = self._median(self.buf)
            mad = self._median([abs(b - med) for b in self.buf])
            scale = _scale_floor(1.4826 * mad, med, self.rel_floor,
                                 self.abs_floor)
            score = (x - med) / scale
            self.last_score = score
            if abs(score) > self.z:
                fired = (score, self.z, "high" if score > 0 else "low")
        self.buf.append(x)
        if len(self.buf) > self.window:
            self.buf.pop(0)
        return fired

    def state(self) -> dict:
        return {"window": len(self.buf), "samples": self.count,
                "last_score": self.last_score}


class Cusum:
    """Two-sided CUSUM against a frozen early baseline.

    The first ``min_samples`` observations define the baseline mean and
    (population) standard deviation; every later sample is standardized
    against it and accumulated into the classic one-sided statistics
    ``s_pos = max(0, s_pos + z - k)`` / ``s_neg = max(0, s_neg - z - k)``.
    Crossing ``h`` fires and resets both accumulators (so a persistent
    shift re-alerts at a bounded rate instead of once per sample).
    """

    name = "cusum"

    def __init__(self, k: float = 0.5, h: float = 5.0,
                 min_samples: int = 8, rel_floor: float = _REL_FLOOR,
                 abs_floor: float = _ABS_FLOOR):
        if min_samples < 2:
            raise ValueError("min_samples must be >= 2")
        self.k = float(k)
        self.h = float(h)
        self.min_samples = int(min_samples)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.baseline: List[float] = []
        self.mean = 0.0
        self.std = 0.0
        self.s_pos = 0.0
        self.s_neg = 0.0
        self.count = 0

    def update(self, x: float) -> Optional[Tuple[float, float, str]]:
        x = float(x)
        self.count += 1
        if len(self.baseline) < self.min_samples:
            self.baseline.append(x)
            if len(self.baseline) == self.min_samples:
                n = len(self.baseline)
                self.mean = sum(self.baseline) / n
                var = sum((b - self.mean) ** 2 for b in self.baseline) / n
                self.std = _scale_floor(math.sqrt(var), self.mean,
                                        self.rel_floor, self.abs_floor)
            return None
        z = (x - self.mean) / self.std
        self.s_pos = max(0.0, self.s_pos + z - self.k)
        self.s_neg = max(0.0, self.s_neg - z - self.k)
        if self.s_pos > self.h:
            score, self.s_pos, self.s_neg = self.s_pos, 0.0, 0.0
            return (score, self.h, "high")
        if self.s_neg > self.h:
            score, self.s_pos, self.s_neg = self.s_neg, 0.0, 0.0
            return (-score, self.h, "low")
        return None

    def state(self) -> dict:
        return {"samples": self.count, "s_pos": self.s_pos,
                "s_neg": self.s_neg,
                "baseline_mean": self.mean if self.baseline else float("nan"),
                "baseline_std": self.std if self.baseline else float("nan")}


@dataclasses.dataclass(frozen=True)
class Rule:
    """Route one metric stream to one detector factory."""

    metric: str                            # registry name to watch
    make: Callable[[], object]             # detector factory
    kinds: Tuple[str, ...] = ("gauge", "hist")   # event kinds that feed it


def default_rules() -> Tuple[Rule, ...]:
    """The shipped monitor set — one detector per predictable-health axis.

    Tuned for the simulator's scales AND its stream shapes.  The fleet
    streams (``worker.completion_s``, ``phase.tail_p95_s``) interleave
    heterogeneous phase types — gradient, Hessian-sketch, and line-search
    fan-outs have different worker counts and flop loads — so their
    in-stream variance understates healthy spread; those detectors carry
    ``rel_floor=0.25``: a deviation must exceed 25% of the stream's level
    (per scale unit) before it scores at all.  Per-iteration optimizer
    streams are homogeneous and keep the tight default floor.  The
    combination keeps healthy golden-trace replays silent (pinned by
    tests) while a real shift — e.g. phase work jumping 4x — still fires
    within a handful of samples.
    """
    return (
        # Straggler tails: per-worker completions drift (fleet degrades).
        # h=25: a legitimate 3x straggler tail scores z ~ 8, so isolated
        # tails at the model's few-percent rate can't sum to a firing,
        # while a sustained 4x shift (z ~ 12 every sample) fires within
        # two or three samples of the change.
        Rule("worker.completion_s", lambda: Cusum(k=0.75, h=25.0,
                                                  min_samples=16,
                                                  rel_floor=0.25)),
        # Per-phase p95 completion: spike = one pathological fan-out.
        Rule("phase.tail_p95_s", lambda: RobustZScore(window=20, z=4.0,
                                                      rel_floor=0.25)),
        # Cost per iteration (set by the optimizer loop).
        Rule("newton.iter_dollars", lambda: RobustZScore(window=12, z=4.0,
                                                         min_samples=4,
                                                         rel_floor=0.05)),
        Rule("newton.iter_seconds", lambda: RobustZScore(window=12, z=4.0,
                                                         min_samples=4,
                                                         rel_floor=0.05)),
        # CG iteration budget blowup.
        Rule("newton.cg_iters", lambda: RobustZScore(window=12, z=3.0,
                                                     min_samples=4)),
        Rule("giant.cg_iters", lambda: RobustZScore(window=12, z=3.0,
                                                    min_samples=4)),
        # Marchenko-Pastur debias factor drift (survivors thinning out).
        # The factor lives in (0, 1]; an absolute floor of 0.02 makes the
        # unit of drift "2 percentage points of debias".
        Rule("sketch.mp_debias", lambda: Cusum(k=0.5, h=6.0, min_samples=4,
                                               abs_floor=0.02)),
        # Warm-pool hit rate collapse.  Watches the *per-phase* ratio
        # (``pool.phase_hit_rate``), not the cumulative ``pool.hit_rate``:
        # the cumulative gauge is smoothed by all prior phases, so a
        # sudden collapse (container-death cull, tenant burst) barely
        # moves it while the phase stream drops to zero immediately.
        Rule("pool.phase_hit_rate", lambda: Cusum(k=0.5, h=6.0,
                                                  min_samples=6,
                                                  abs_floor=0.05)),
        # Coded-matvec corruption rate (per-phase gauge from the coded
        # engine whenever a fault plan's CorruptionSpec is attached; 0.0
        # on clean phases, so the baseline is exact and any sustained
        # corruption drifts the CUSUM up).  Unit of drift: 2% of blocks.
        Rule("coded.block_error_rate", lambda: Cusum(k=0.5, h=6.0,
                                                     min_samples=6,
                                                     abs_floor=0.02)),
    )


class HealthMonitors:
    """Registry listener that runs every matching rule's detector online.

    Attach with ``obs.Telemetry(monitors=HealthMonitors())`` (or
    ``monitors.attach(tel)`` after the fact).  Detectors are lazily
    instantiated per metric on first sample, so one monitor set serves
    any mix of optimizers.
    """

    def __init__(self, rules: Optional[Sequence[Rule]] = None):
        self.rules: Tuple[Rule, ...] = tuple(
            default_rules() if rules is None else rules)
        self._by_metric: Dict[str, List[Tuple[int, Rule]]] = {}
        for i, r in enumerate(self.rules):
            self._by_metric.setdefault(r.metric, []).append((i, r))
        self.detectors: Dict[Tuple[str, int], object] = {}
        self.alerts: List[Alert] = []
        self._tel = None

    # -------------------------------------------------------------- wiring
    def attach(self, telemetry) -> "HealthMonitors":
        """Become ``telemetry``'s metric listener (and alert emitter)."""
        self._tel = telemetry
        telemetry.metrics.listener = self
        telemetry.health = self
        return self

    # ------------------------------------------------------------ listener
    def on_metric(self, kind: str, name: str, delta: float,
                  value: float) -> None:
        rules = self._by_metric.get(name)
        if not rules:
            return
        for idx, rule in rules:
            if kind not in rule.kinds:
                continue
            key = (name, idx)
            det = self.detectors.get(key)
            if det is None:
                det = self.detectors[key] = rule.make()
            fired = det.update(value)
            if fired is None:
                continue
            score, threshold, direction = fired
            t = self._tel.trace.last_time if self._tel is not None else 0.0
            alert = Alert(metric=name, detector=det.name, t=t,
                          value=float(value), score=float(score),
                          threshold=float(threshold), sample=det.count,
                          direction=direction)
            self.alerts.append(alert)
            if self._tel is not None and self._tel.trace.enabled:
                self._tel.trace.emit(
                    f"alert:{name}", "alert", t, t, metric=name,
                    detector=det.name, value=float(value),
                    score=float(score), direction=direction)

    # -------------------------------------------------------------- export
    def alert_windows(self, merge_gap: float = 1.0
                      ) -> List[Tuple[float, float, List[Alert]]]:
        """Cluster alerts into time windows: consecutive alerts closer
        than ``merge_gap`` simulated seconds share one window.  Returns
        ``(t_start, t_end, alerts)`` triples in time order — the unit of
        attribution for ``repro_torch.obs.incident``."""
        if not self.alerts:
            return []
        ordered = sorted(self.alerts, key=lambda a: (a.t, a.metric,
                                                     a.detector))
        windows: List[Tuple[float, float, List[Alert]]] = []
        t0 = t1 = ordered[0].t
        bucket = [ordered[0]]
        for a in ordered[1:]:
            if a.t - t1 <= merge_gap:
                t1 = a.t
                bucket.append(a)
            else:
                windows.append((t0, t1, bucket))
                t0 = t1 = a.t
                bucket = [a]
        windows.append((t0, t1, bucket))
        return windows

    def state_rows(self) -> List[dict]:
        """Per-detector state for reports and the JSONL ``health`` row."""
        rows = []
        for (metric, _), det in sorted(self.detectors.items(),
                                       key=lambda kv: (kv[0][0],
                                                       kv[1].name)):
            n_alerts = sum(1 for a in self.alerts
                           if a.metric == metric
                           and a.detector == det.name)
            rows.append({"metric": metric, "detector": det.name,
                         "alerts": n_alerts, **det.state()})
        return rows

    def summary(self) -> dict:
        return {"alerts": len(self.alerts),
                "metrics_watched": len(self.detectors),
                "by_metric": {m: sum(1 for a in self.alerts if a.metric == m)
                              for m in sorted({a.metric
                                               for a in self.alerts})}}
