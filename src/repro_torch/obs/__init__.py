"""Fleet telemetry: span tracing, metrics, Perfetto export, critical path.

The observability layer for the simulated serverless stack.  One
``Telemetry`` object bundles a hierarchical span tracer (run -> iteration
-> DAG phase -> per-worker lifecycle attempt, all stamped on the
*simulated* clock) with a metrics registry (counters / gauges /
histograms); exporters render the result as a Perfetto-loadable Chrome
trace, a JSONL dump, or summary tables.

The default everywhere is ``obs.NULL`` — a zero-overhead no-op whose
methods return immediately, draw no randomness, and read no clock, so
attaching or detaching telemetry never changes a single simulated
``(seconds, dollars)`` total (the golden-trace tests pin this).

Attach points (see ``src/repro/obs/README.md`` for the span model and
metric names):

    tel = obs.Telemetry()
    clock = SimClock(model, telemetry=tel)        # fleet + scheduler seams
    res = oversketched_newton(obj, data, w0, cfg, model=clock)
    obs.perfetto.dump(obs.to_perfetto(tel.trace.spans), "run.perfetto.json")
    print(obs.phase_table(obs.telemetry_rows(tel)))
"""
from repro_torch.obs.critical_path import (CriticalPathReport, PhaseSlack,
                                     critical_path, from_dag)
from repro_torch.obs.export import (alert_table, alerts_from_rows,
                              bench_rows_table, critical_path_table,
                              dag_reports_from_rows, detector_table,
                              dump_jsonl, format_table, load_jsonl,
                              phase_summary_rows, phase_table,
                              telemetry_rows)
from repro_torch.obs.health import (Alert, Cusum, HealthMonitors, RobustZScore,
                              Rule, default_rules)
from repro_torch.obs.incident import (CAUSES, Evidence, Incident, IncidentConfig,
                                attribute, attribute_rows, dump_incidents,
                                incident_rows, incident_table)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               NullMetrics)
from repro_torch.obs.perfetto import (counter_series, dumps_stable, to_perfetto,
                                validate_file, validate_trace)
from repro_torch.obs.perfetto import dump as dump_perfetto
from repro_torch.obs.console import render as render_console
from repro_torch.obs.console import write_console
from repro_torch.obs.diff import DiffReport, RowDiff, diff_bench, diff_rows, diff_store
from repro_torch.obs.slo import SloPolicy, SloTracker
from repro_torch.obs.span import NullTracer, Span, SpanTracer
from repro_torch.obs.store import (Store, bench_record, config_hash, git_sha,
                             run_record)


class Telemetry:
    """A live tracer + metrics registry pair; pass to ``SimClock``.

    ``monitors`` optionally attaches a ``health.HealthMonitors`` (or
    ``monitors=True`` for the default rule set): the streaming anomaly
    detectors then watch every metric update and record ``Alert``s —
    still pure observation, the simulation cannot tell the difference.
    """

    enabled = True

    def __init__(self, monitors=None):
        self.trace = SpanTracer()
        # Gauges/histograms timestamp their points off the span tracer's
        # simulated-clock high-water mark — what counter tracks and SLO
        # burn charts plot against.
        self.metrics = MetricsRegistry(
            timesource=lambda: self.trace.last_time)
        self.health = None
        # Set by repro_torch.obs.incident.attribute / repro_torch.tenancy's scheduler
        # when those planes run; exports pick them up via getattr.
        self.incidents = None
        self.slo = None
        if monitors is True:
            monitors = HealthMonitors()
        if monitors is not None:
            monitors.attach(self)


class _NullTelemetry:
    """The zero-overhead default: both halves are no-ops."""

    enabled = False
    health = None
    incidents = None
    slo = None

    def __init__(self):
        self.trace = NullTracer()
        self.metrics = NullMetrics()


NULL = _NullTelemetry()


__all__ = [
    "Telemetry", "NULL",
    "Span", "SpanTracer", "NullTracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullMetrics",
    "Alert", "Cusum", "HealthMonitors", "RobustZScore", "Rule",
    "default_rules",
    "Store", "bench_record", "run_record", "config_hash", "git_sha",
    "DiffReport", "RowDiff", "diff_bench", "diff_rows", "diff_store",
    "CriticalPathReport", "PhaseSlack", "critical_path", "from_dag",
    "to_perfetto", "dumps_stable", "dump_perfetto", "validate_trace",
    "validate_file", "counter_series",
    "telemetry_rows", "dump_jsonl", "load_jsonl", "format_table",
    "phase_table", "phase_summary_rows", "critical_path_table",
    "dag_reports_from_rows", "bench_rows_table",
    "alert_table", "alerts_from_rows", "detector_table",
    "CAUSES", "Evidence", "Incident", "IncidentConfig", "attribute",
    "attribute_rows", "dump_incidents", "incident_rows", "incident_table",
    "SloPolicy", "SloTracker",
    "render_console", "write_console",
]
