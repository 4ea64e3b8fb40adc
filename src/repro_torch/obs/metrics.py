"""Metrics registry: counters, gauges, and histograms for fleet telemetry.

Three instrument types, auto-created on first touch (``registry.counter
("fleet.cold_starts").inc()``), mirroring the Prometheus surface every
operator already knows:

  - ``Counter`` — monotone totals: attempts, retries, cold starts, warm
    hits, adaptive-sketch growth events, kernel-path selections.
  - ``Gauge`` — last-value-wins with the full series kept: adaptive sketch
    rows m, the measured Marchenko-Pastur debias factor, CG iteration
    budget, warm-pool free containers.
  - ``Histogram`` — full-sample distributions with exact percentiles (the
    sample counts here are thousands, not millions — no bucketing error):
    per-worker completion times (the Fig. 1 straggler tail), per-phase
    elapsed seconds, GB-seconds, and dollars, kernel wall-clock.

``NullMetrics`` is the zero-overhead default: every instrument lookup
returns one shared no-op instance.  Like the tracer, the registry draws no
randomness and reads no clock, so attaching it never perturbs a run.

Metric names are dotted paths (``fleet.cold_starts``, ``phase.dollars``,
``kernel.path.fused_tiled``); ``snapshot()`` returns them sorted, so the
JSONL export is deterministic.

A registry optionally carries a ``listener`` — anything with an
``on_metric(kind, name, delta, value)`` method (``repro_torch.obs.health``'s
streaming anomaly detectors are the shipped one).  Every instrument update
forwards through it, which is what makes online monitoring possible
without a second instrumentation pass; a listener is itself pure
observation and must never mutate the run.

It may also carry a ``timesource`` — a zero-argument callable returning
the current simulated time (``Telemetry`` wires it to the span tracer's
``last_time`` high-water mark).  When present, every gauge ``set`` and
histogram ``observe`` also appends a ``(t, value)`` point to the
instrument's ``points`` list, which is what the Perfetto counter-track
export (``obs.counter_series``) and the console's burn charts render.
Reading a high-water mark draws no randomness and moves no clock, so the
observation-only contract is untouched; without a timesource (the
default for a bare ``MetricsRegistry()``) nothing extra is recorded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class Counter:
    value: float = 0.0
    name: str = ""
    registry: Optional["MetricsRegistry"] = dataclasses.field(
        default=None, repr=False, compare=False)

    def inc(self, v: float = 1.0) -> None:
        self.value += v
        reg = self.registry
        if reg is not None and reg.listener is not None:
            reg.listener.on_metric("counter", self.name, v, self.value)


@dataclasses.dataclass
class Gauge:
    """Last value wins; the series is kept for per-iteration plots."""

    value: float = 0.0
    series: List[float] = dataclasses.field(default_factory=list)
    name: str = ""
    registry: Optional["MetricsRegistry"] = dataclasses.field(
        default=None, repr=False, compare=False)
    #: (t, value) pairs, recorded only when the registry has a timesource.
    points: List[tuple] = dataclasses.field(default_factory=list,
                                            compare=False)

    def set(self, v: float) -> None:
        self.value = float(v)
        self.series.append(self.value)
        reg = self.registry
        if reg is not None:
            if reg.timesource is not None:
                self.points.append((float(reg.timesource()), self.value))
            if reg.listener is not None:
                reg.listener.on_metric("gauge", self.name, self.value,
                                       self.value)


@dataclasses.dataclass
class Histogram:
    values: List[float] = dataclasses.field(default_factory=list)
    name: str = ""
    registry: Optional["MetricsRegistry"] = dataclasses.field(
        default=None, repr=False, compare=False)
    #: (t, value) pairs, recorded only when the registry has a timesource.
    points: List[tuple] = dataclasses.field(default_factory=list,
                                            compare=False)

    def observe(self, v: float) -> None:
        self.values.append(float(v))
        reg = self.registry
        if reg is not None:
            if reg.timesource is not None:
                self.points.append((float(reg.timesource()), float(v)))
            if reg.listener is not None:
                reg.listener.on_metric("hist", self.name, float(v), float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return sum(self.values)

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile, q in [0, 100]; NaN when empty."""
        if not self.values:
            return float("nan")
        xs = sorted(self.values)
        rank = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
        return xs[rank]

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p95": self.percentile(95), "p99": self.percentile(99),
                "max": max(self.values) if self.values else float("nan")}


class MetricsRegistry:
    enabled = True

    def __init__(self, listener=None, timesource=None):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        # Optional on_metric(kind, name, delta, value) observer — the hook
        # repro_torch.obs.health's online detectors attach through.  May be set
        # after instruments already exist; they all hold a registry
        # back-reference, so late attachment sees every later update.
        self.listener = listener
        # Optional zero-arg simulated-clock reader; when set, gauges and
        # histograms keep timestamped (t, value) points (module docstring).
        self.timesource = timesource

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name,
                                        Counter(name=name, registry=self))

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge(name=name, registry=self))

    def histogram(self, name: str) -> Histogram:
        return self.histograms.setdefault(name,
                                          Histogram(name=name, registry=self))

    def snapshot(self) -> dict:
        """Deterministic (sorted-name) dump of every instrument."""
        return {
            "counters": {n: c.value
                         for n, c in sorted(self.counters.items())},
            "gauges": {n: {"value": g.value, "n": len(g.series)}
                       for n, g in sorted(self.gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self.histograms.items())},
        }


class _NullInstrument:
    """One shared instance behind every NullMetrics lookup."""

    value = 0.0
    values: List[float] = []
    series: List[float] = []
    points: List[tuple] = []
    count = 0
    total = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def percentile(self, q: float) -> float:
        return float("nan")

    def summary(self) -> dict:
        return {}


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    enabled = False
    counters: Dict[str, Counter] = {}
    gauges: Dict[str, Gauge] = {}
    histograms: Dict[str, Histogram] = {}
    listener = None
    timesource = None

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}
