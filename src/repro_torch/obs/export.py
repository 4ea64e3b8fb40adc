"""JSONL export + summary-table rendering of recorded telemetry.

Two consumers:

  - ``dump_jsonl`` writes one run's telemetry as JSONL — span rows first
    (in emission order), then one ``{"kind": "metrics"}`` row with the
    registry snapshot — the machine-readable sibling of the Perfetto
    export, and what ``benchmarks.make_report --trace`` renders tables
    from.
  - The formatters: ``format_table`` is the one table renderer every
    benchmark summary shares (markdown-style, right-aligned numerics),
    ``phase_summary_rows`` aggregates phase spans into the per-phase
    time/dollar breakdown, and ``critical_path_rows`` tabulates a
    ``CriticalPathReport``.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.obs.critical_path import CriticalPathReport, critical_path
from repro_torch.obs.span import Span


# ----------------------------------------------------------------- JSONL
def telemetry_rows(telemetry) -> List[dict]:
    """Span rows, health-monitor alert/state rows (when monitors are
    attached), attributed incident rows (``repro_torch.obs.incident``), SLO
    rows (``repro_torch.obs.slo``), then one metrics row — JSON-ready."""
    rows = [s.as_row() for s in telemetry.trace.spans]
    health = getattr(telemetry, "health", None)
    if health is not None:
        rows.extend(a.as_row() for a in health.alerts)
        rows.append({"kind": "health", "detectors": health.state_rows(),
                     **health.summary()})
    incidents = getattr(telemetry, "incidents", None)
    if incidents:
        rows.extend(inc.as_row() for inc in incidents)
    slo = getattr(telemetry, "slo", None)
    if slo is not None:
        rows.extend(slo.rows())
    rows.append({"kind": "metrics", **telemetry.metrics.snapshot()})
    return rows


def dump_jsonl(telemetry, path) -> None:
    with open(path, "w") as f:
        for row in telemetry_rows(telemetry):
            f.write(json.dumps(row, sort_keys=True) + "\n")


def load_jsonl(path) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------- tables
def format_table(headers: Sequence[str], rows: Iterable[Sequence[object]],
                 floatfmt: str = ".4g") -> str:
    """Markdown table with aligned columns; floats via ``floatfmt``."""

    def fmt(v) -> str:
        if isinstance(v, bool):
            return "yes" if v else ""
        if isinstance(v, float):
            return format(v, floatfmt)
        return str(v)

    cells = [[fmt(v) for v in row] for row in rows]
    widths = [max([len(h)] + [len(r[i]) for r in cells])
              for i, h in enumerate(headers)]

    def line(vals):
        return "| " + " | ".join(v.ljust(w) for v, w in zip(vals, widths)) \
            + " |"

    out = [line(list(headers)),
           "|" + "|".join("-" * (w + 2) for w in widths) + "|"]
    out.extend(line(r) for r in cells)
    return "\n".join(out)


def phase_summary_rows(phase_rows: Iterable[dict]) -> List[dict]:
    """Aggregate phase span rows (``as_row`` dicts or JSONL rows) into the
    per-phase breakdown: count, total seconds, total dollars, workers."""
    agg: Dict[str, dict] = {}
    for r in phase_rows:
        if r.get("span_kind") not in ("phase", "charge"):
            continue
        name = r["name"]
        a = agg.setdefault(name, {"phase": name, "count": 0, "seconds": 0.0,
                                  "dollars": 0.0, "gb_seconds": 0.0,
                                  "workers": 0})
        a["count"] += 1
        a["seconds"] += r["end"] - r["start"]
        attrs = r.get("attrs", {})
        a["dollars"] += float(attrs.get("dollars", 0.0))
        a["gb_seconds"] += float(attrs.get("gb_seconds", 0.0))
        a["workers"] = max(a["workers"], int(attrs.get("workers", 0)))
    return sorted(agg.values(), key=lambda a: -a["seconds"])


def phase_table(phase_rows: Iterable[dict]) -> str:
    rows = phase_summary_rows(phase_rows)
    total_s = sum(r["seconds"] for r in rows)
    total_d = sum(r["dollars"] for r in rows)
    body = [(r["phase"], r["count"], r["workers"], r["seconds"],
             (100.0 * r["seconds"] / total_s) if total_s else 0.0,
             r["gb_seconds"], r["dollars"]) for r in rows]
    body.append(("TOTAL", sum(r["count"] for r in rows), "",
                 total_s, 100.0 if total_s else 0.0,
                 sum(r["gb_seconds"] for r in rows), total_d))
    return format_table(
        ("phase", "n", "workers", "seconds", "%time", "GB-s", "dollars"),
        body)


def critical_path_rows(report: CriticalPathReport) -> List[Sequence[object]]:
    return [(r["phase"], r["start"], r["finish"], r["duration"], r["slack"],
             r["critical"]) for r in report.rows()]


def critical_path_table(report: CriticalPathReport) -> str:
    head = (f"makespan {report.makespan:.4g}s; critical path: "
            + " -> ".join(report.critical_path)
            + f" ({report.critical_seconds:.4g}s on-chain)")
    return head + "\n" + format_table(
        ("phase", "start", "finish", "duration", "slack", "critical"),
        critical_path_rows(report))


def dag_reports_from_rows(rows: Iterable[dict]) -> List[CriticalPathReport]:
    """Reconstruct per-DAG critical-path reports from exported span rows.

    Phase spans dispatched through ``scheduler.DagRun`` carry a ``deps``
    attribute; spans sharing a parent (one iteration span) form one DAG.
    Groups in which no span recorded deps (pure sequential dispatch) are
    skipped.
    """
    groups: Dict[int, Dict[str, tuple]] = {}
    has_deps: Dict[int, bool] = {}
    for r in rows:
        if r.get("span_kind") != "phase":
            continue
        attrs = r.get("attrs", {})
        if "deps" not in attrs:
            continue
        parent = r.get("parent", 0)
        groups.setdefault(parent, {})[r["name"]] = (
            r["start"], r["end"], tuple(attrs["deps"]))
        has_deps[parent] = has_deps.get(parent, False) or bool(attrs["deps"])
    return [critical_path(g) for parent, g in sorted(groups.items())
            if has_deps[parent]]


# ------------------------------------------------------- health / alerts
def alerts_from_rows(rows: Iterable[dict]) -> List[dict]:
    """The ``kind: "alert"`` rows of a JSONL export (file order)."""
    return [r for r in rows if r.get("kind") == "alert"]


def alert_table(rows: Iterable[dict]) -> str:
    """Tabulate alert rows (``Alert.as_row()`` dicts carry
    ``kind: "alert"``, so a full JSONL export can be passed directly)."""
    alerts = alerts_from_rows(rows)
    body = [(a["t"], a["metric"], a["detector"], a["direction"], a["value"],
             a["score"], a["threshold"], a["sample"]) for a in alerts]
    return format_table(("t(s)", "metric", "detector", "dir", "value",
                         "score", "limit", "sample#"), body)


def detector_table(rows: Iterable[dict]) -> str:
    """Per-detector state table from a JSONL export's ``health`` row (or
    directly from ``HealthMonitors.state_rows()`` dicts)."""
    rows = list(rows)
    health = next((r for r in rows if r.get("kind") == "health"), None)
    states = health["detectors"] if health is not None else rows
    body = []
    for s in states:
        extras = "; ".join(f"{k}={format(v, '.4g') if isinstance(v, float) else v}"
                           for k, v in sorted(s.items())
                           if k not in ("metric", "detector", "alerts",
                                        "samples"))
        body.append((s["metric"], s["detector"], s.get("samples", ""),
                     s.get("alerts", 0), extras))
    return format_table(("metric", "detector", "samples", "alerts", "state"),
                        body)


# ------------------------------------------------- benchmark row formatter
def bench_rows_table(rows: Iterable[dict]) -> str:
    """The shared summary formatter for ``benchmarks.common.json_row``
    rows: the ``derived`` k=v blob is split back into columns."""
    rows = list(rows)
    keys: List[str] = []
    parsed = []
    for r in rows:
        kv = {}
        for part in str(r.get("derived", "")).split(";"):
            if "=" in part:
                k, v = part.split("=", 1)
                kv[k] = v
                if k not in keys:
                    keys.append(k)
        parsed.append(kv)
    headers = ["name", "us_per_call"] + keys
    body = [[r["name"], f"{r['us']:.1f}"] + [kv.get(k, "") for k in keys]
            for r, kv in zip(rows, parsed)]
    return format_table(headers, body)
