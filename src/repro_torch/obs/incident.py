"""Alert -> root-cause attribution: typed, ranked, deterministic incidents.

The health monitors (``repro_torch.obs.health``) say *that* something degraded;
this module says *why*.  ``attribute`` clusters a run's alerts into time
windows and correlates each window against every evidence stream the
stack records:

  - **Injected-fault signatures** — the per-phase nonzero fault counters
    the engine attaches to phase spans when a ``FaultPlan`` is active
    (``attrs["faults"]``: burst kills, throttle rejections, S3 retries,
    OOM kills, pool culls, corrupted workers).
  - **Declared fault windows** — ``FaultPlan.events()``: what the chaos
    plan *said* it would do, and when.
  - **Critical path & slack** — CPM reports reconstructed from the
    dispatched DAGs' recorded deps: whether the blamed phase was on the
    critical path (an incident there costs makespan; one in slack may
    not).
  - **Tenant attribution** — phase spans labelled ``tenant/job/phase``
    by the tenancy scheduler plus its ``job`` spans: which tenant's
    dollars dominate the window (a noisy neighbour is a cause in its own
    right).
  - **Sketch-quality gauges** — ``sketch.mp_debias`` / ``sketch.
    survivors`` / CG-count alerts point at sketch-quality drift rather
    than fleet trouble.

Every hypothesis accumulates weighted ``Evidence``; causes are ranked by
total weight and the window becomes one typed ``Incident`` (top cause,
full ranking, evidence list with span links, blamed tenant/phase/worker
cohort, seconds + dollars impact).  Attribution is a pure function of
already-recorded telemetry — it draws no randomness, reads no wall
clock, and never touches the simulation, so the same seed and the same
``FaultPlan`` yield byte-identical incident JSONL (pinned by a committed
golden fixture).  Like everything in ``obs``, it composes with the
inertness contract: running ``attribute`` after a run cannot change its
``(seconds, dollars)`` totals.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: The typed cause vocabulary, ranked hypotheses draw from exactly this
#: set.  The first six mirror the chaos-plane scenario registry
#: (``repro_torch.runtime.faults.available_scenarios``); the rest are organic
#: causes no plan declares.
CAUSES = ("az_burst", "throttle", "s3_transient", "oom", "pool_death",
          "corruption", "pool_collapse", "tenant_hog", "sketch_quality",
          "workload_shift", "unknown")

#: Per-phase injected-fault counter -> the cause it is a signature of.
SIGNATURES = {
    "burst_kills": "az_burst",
    "throttled": "throttle",
    "s3_get_retries": "s3_transient",
    "s3_put_retries": "s3_transient",
    "oom_kills": "oom",
    "oom_escalations": "oom",
    "pool_killed": "pool_death",
    "corrupted_workers": "corruption",
}

#: Alert metric -> causes it is a known symptom of.  Straggler-stream
#: alerts are deliberately broad: most failure modes present as a fatter
#: completion tail, so the symptom only breaks ties that signatures and
#: declared windows leave open.
SYMPTOMS = {
    "worker.completion_s": ("az_burst", "throttle", "s3_transient", "oom",
                            "workload_shift"),
    "phase.tail_p95_s": ("az_burst", "throttle", "s3_transient", "oom",
                         "workload_shift"),
    "newton.iter_seconds": ("workload_shift",),
    "newton.iter_dollars": ("workload_shift",),
    "pool.phase_hit_rate": ("pool_death", "pool_collapse"),
    "coded.block_error_rate": ("corruption",),
    "sketch.mp_debias": ("sketch_quality",),
    "newton.cg_iters": ("sketch_quality",),
    "giant.cg_iters": ("sketch_quality",),
}

# Evidence weights: a declared plan window is the strongest signal (the
# chaos plane told us), a recorded per-phase signature nearly as strong
# (the engine saw it happen), symptoms only break ties.
W_PLAN = 4.0
W_SIGNATURE = 3.0
W_SYMPTOM = 0.5
W_TENANT = 2.0
W_ORGANIC = 1.5          # pool_collapse / workload_shift when nothing else fits


@dataclasses.dataclass(frozen=True)
class IncidentConfig:
    """Attribution knobs; the defaults match the simulator's scales."""

    merge_gap_s: float = 1.0   # alerts closer than this share a window
    pad_s: float = 0.5         # window padding when matching phase spans
    tenant_share: float = 0.65  # dollar share that makes a tenant a hog


@dataclasses.dataclass
class Evidence:
    """One weighted observation supporting one cause hypothesis."""

    cause: str      # the hypothesis this supports (one of CAUSES)
    kind: str       # "fault_plan"|"fault_stat"|"symptom"|"tenant"|"organic"
    detail: str     # human-readable statement
    weight: float
    t: float        # simulated seconds the observation anchors to
    span: Optional[int] = None   # supporting span id, when there is one

    def as_dict(self) -> dict:
        d = {"cause": self.cause, "kind": self.kind, "detail": self.detail,
             "weight": self.weight, "t": self.t}
        if self.span is not None:
            d["span"] = self.span
        return d


@dataclasses.dataclass
class Incident:
    """One attributed alert window."""

    id: int
    cause: str                       # top-ranked hypothesis
    score: float                     # its evidence weight
    t_start: float
    t_end: float
    hypotheses: List[Tuple[str, float]]   # full ranking, best first
    evidence: List[Evidence]
    n_alerts: int
    alert_metrics: List[str]
    tenant: Optional[str]            # blamed tenant (dollar-dominant)
    phase: Optional[str]             # blamed phase (dollar-dominant)
    on_critical_path: Optional[bool]  # blamed phase on the CPM chain?
    cohort: Dict[str, int]           # failed/retry attempt counts in window
    impact_seconds: float            # window extent over affected phases
    impact_dollars: float            # dollars of overlapping phases
    span: Optional[int] = None       # the linked "incident" span, if emitted

    def as_row(self) -> dict:
        """JSONL-ready dict (``kind: "incident"``), fully deterministic."""
        return {"kind": "incident", "id": self.id, "cause": self.cause,
                "score": round(self.score, 6),
                "t_start": self.t_start, "t_end": self.t_end,
                "hypotheses": [[c, round(s, 6)] for c, s in self.hypotheses],
                "evidence": [e.as_dict() for e in self.evidence],
                "n_alerts": self.n_alerts,
                "alert_metrics": self.alert_metrics,
                "tenant": self.tenant, "phase": self.phase,
                "on_critical_path": self.on_critical_path,
                "cohort": self.cohort,
                "impact_seconds": self.impact_seconds,
                "impact_dollars": self.impact_dollars}

    def narrative(self) -> str:
        """One-paragraph operator-readable story for reports/console."""
        parts = [f"[{self.t_start:.3f}s – {self.t_end:.3f}s] "
                 f"cause={self.cause} (score {self.score:.2f}, "
                 f"{self.n_alerts} alert(s) on "
                 f"{', '.join(self.alert_metrics)})."]
        if self.tenant:
            parts.append(f"Blamed tenant: {self.tenant}.")
        if self.phase:
            onoff = ("on" if self.on_critical_path else "off") \
                if self.on_critical_path is not None else "unknown vs"
            parts.append(f"Blamed phase: {self.phase} ({onoff} the "
                         "critical path).")
        if self.cohort.get("failed") or self.cohort.get("retries"):
            parts.append(f"Worker cohort: {self.cohort.get('failed', 0)} "
                         f"failed, {self.cohort.get('retries', 0)} retried "
                         f"attempts across {self.cohort.get('workers', 0)} "
                         "tracks.")
        parts.append(f"Impact: {self.impact_seconds:.3f}s, "
                     f"${self.impact_dollars:.6f}.")
        if len(self.hypotheses) > 1:
            alt = ", ".join(f"{c}={s:.2f}" for c, s in self.hypotheses[1:4])
            parts.append(f"Runners-up: {alt}.")
        return " ".join(parts)


# --------------------------------------------------------------- internals
def _overlaps(a0: float, a1: float, b0: float, b1: Optional[float]) -> bool:
    return a1 >= b0 and (b1 is None or a0 <= b1)


def _phase_rows(rows: Iterable[dict]) -> List[dict]:
    return [r for r in rows if r.get("kind") == "span"
            and r.get("span_kind") == "phase"]


def _tenants_from_rows(rows: Sequence[dict]) -> List[str]:
    """Tenant names, from the tenancy scheduler's job spans."""
    seen = []
    for r in rows:
        if r.get("kind") == "span" and r.get("span_kind") == "job":
            t = (r.get("attrs") or {}).get("tenant")
            if t and t not in seen:
                seen.append(t)
    return seen


def _critical_sets(rows: Sequence[dict]) -> List[set]:
    """Critical-path phase-name sets of every reconstructable DAG."""
    from repro_torch.obs.export import dag_reports_from_rows
    try:
        return [set(rep.critical_path)
                for rep in dag_reports_from_rows(rows)]
    except Exception:   # noqa: BLE001 — CPM is best-effort evidence
        return []


def _attribute_window(idx: int, t0: float, t1: float, alerts: List[dict],
                      rows: Sequence[dict], fault_events: List[dict],
                      tenants: List[str], critical_sets: List[set],
                      cfg: IncidentConfig) -> Incident:
    lo, hi = t0 - cfg.pad_s, t1 + cfg.pad_s
    evidence: List[Evidence] = []
    phases = [r for r in _phase_rows(rows)
              if r["end"] >= lo and r["start"] <= hi]

    # (a) declared fault windows overlapping this alert window
    for ev in fault_events:
        if _overlaps(lo, hi, ev["t_start"], ev["t_end"]):
            end = "run end" if ev["t_end"] is None else f"{ev['t_end']:.3f}s"
            evidence.append(Evidence(
                ev["cause"], "fault_plan",
                f"FaultPlan declares {ev['cause']} "
                f"[{ev['t_start']:.3f}s – {end}] ({ev['detail']})",
                W_PLAN, ev["t_start"]))

    # (b) per-phase injected-fault signatures recorded on phase spans
    sig_totals: Dict[str, int] = {}
    for r in phases:
        for stat, count in sorted(((r.get("attrs") or {}).get("faults")
                                   or {}).items()):
            cause = SIGNATURES.get(stat)
            if cause is None or not count:
                continue
            sig_totals[stat] = sig_totals.get(stat, 0) + int(count)
            evidence.append(Evidence(
                cause, "fault_stat",
                f"phase {r['name']}: {stat}={int(count)}",
                W_SIGNATURE * min(1.0, 0.25 + 0.25 * math.log10(1 + count)),
                r["start"], span=r.get("id")))

    # (c) alert-metric symptom affinity
    metrics_seen: List[str] = []
    for a in alerts:
        if a["metric"] not in metrics_seen:
            metrics_seen.append(a["metric"])
        for cause in SYMPTOMS.get(a["metric"], ()):
            evidence.append(Evidence(
                cause, "symptom",
                f"{a['detector']} alert on {a['metric']} "
                f"(value {a['value']:.4g}, {a['direction']})",
                W_SYMPTOM, a["t"]))

    # (d) tenant attribution: who spent the window's dollars
    tenant_dollars: Dict[str, float] = {}
    for r in phases:
        name = r["name"]
        head = name.split("/", 1)[0]
        if head in tenants:
            d = float((r.get("attrs") or {}).get("dollars", 0.0))
            tenant_dollars[head] = tenant_dollars.get(head, 0.0) + d
    blamed_tenant = None
    if tenant_dollars:
        blamed_tenant, top_d = max(sorted(tenant_dollars.items()),
                                   key=lambda kv: kv[1])
        total_d = sum(tenant_dollars.values())
        share = top_d / total_d if total_d else 0.0
        if len(tenant_dollars) >= 2 and share >= cfg.tenant_share:
            evidence.append(Evidence(
                "tenant_hog", "tenant",
                f"tenant {blamed_tenant} holds {100 * share:.0f}% of the "
                f"window's phase dollars (${top_d:.6f} of ${total_d:.6f})",
                W_TENANT, t0))

    # (e) organic causes when the declared/recorded streams are silent
    declared = {ev["cause"] for ev in fault_events}
    sig_causes = {SIGNATURES[s] for s in sig_totals}
    if ("pool.phase_hit_rate" in metrics_seen
            and "pool_death" not in declared
            and "pool_killed" not in sig_totals):
        evidence.append(Evidence(
            "pool_collapse", "organic",
            "warm-pool hit rate collapsed with no declared or recorded "
            "container cull — organic pool churn", W_ORGANIC, t0))
    straggler = {"worker.completion_s", "phase.tail_p95_s"}
    if (set(metrics_seen) & straggler) and not declared and not sig_causes:
        evidence.append(Evidence(
            "workload_shift", "organic",
            "straggler tail shifted with no fault plan active and no "
            "injected-fault signature — the workload itself changed",
            W_ORGANIC, t0))

    # Rank hypotheses by accumulated evidence weight (name-ordered ties).
    scores: Dict[str, float] = {}
    for e in evidence:
        scores[e.cause] = scores.get(e.cause, 0.0) + e.weight
    ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
    if not ranked:
        ranked = [("unknown", 0.0)]
    cause, score = ranked[0]

    # Blamed phase: the dollar-dominant overlapping phase; critical-path
    # membership from any reconstructed DAG that contains it.
    blamed_phase = None
    on_cp: Optional[bool] = None
    if phases:
        blamed = max(phases,
                     key=lambda r: (float((r.get("attrs") or {})
                                          .get("dollars", 0.0)),
                                    -r["start"]))
        blamed_phase = blamed["name"]
        if critical_sets:
            on_cp = any(blamed_phase in cs for cs in critical_sets)
            which = "ON" if on_cp else "OFF"
            evidence.append(Evidence(
                cause, "critical_path",
                f"blamed phase {blamed_phase} is {which} the CPM critical "
                "path of its DAG", 0.0, blamed["start"],
                span=blamed.get("id")))

    # Worker cohort: failed/retry attempt spans inside the window.
    failed = retries = 0
    tracks = set()
    for r in rows:
        if (r.get("kind") == "span" and r.get("span_kind") == "attempt"
                and r["end"] >= lo and r["start"] <= hi):
            if r["name"] == "failed":
                failed += 1
                tracks.add(r.get("track"))
            elif r["name"] == "retry":
                retries += 1
                tracks.add(r.get("track"))
    cohort = {"failed": failed, "retries": retries,
              "workers": len(tracks - {None})}

    if phases:
        impact_s = (max(r["end"] for r in phases)
                    - min(r["start"] for r in phases))
        impact_d = sum(float((r.get("attrs") or {}).get("dollars", 0.0))
                       for r in phases)
    else:
        impact_s, impact_d = t1 - t0, 0.0

    evidence.sort(key=lambda e: (-e.weight, e.cause, e.t, e.detail))
    return Incident(
        id=idx, cause=cause, score=score, t_start=t0, t_end=t1,
        hypotheses=ranked, evidence=evidence, n_alerts=len(alerts),
        alert_metrics=metrics_seen, tenant=blamed_tenant,
        phase=blamed_phase, on_critical_path=on_cp, cohort=cohort,
        impact_seconds=impact_s, impact_dollars=impact_d)


# ------------------------------------------------------------- public API
def attribute_rows(rows: Sequence[dict], alerts: Sequence[dict],
                   fault_events: Optional[Sequence[dict]] = None,
                   config: IncidentConfig = IncidentConfig()
                   ) -> List[Incident]:
    """Core attribution on exported rows: cluster ``alerts`` into windows
    (``merge_gap_s``), attribute each against ``rows`` (span rows) and the
    declared ``fault_events`` (``FaultPlan.events()``), and return
    incidents ranked most-severe (highest score) first."""
    if not alerts:
        return []
    fault_events = list(fault_events or ())
    ordered = sorted(alerts, key=lambda a: (a["t"], a["metric"],
                                            a["detector"]))
    windows: List[Tuple[float, float, List[dict]]] = []
    t0 = t1 = ordered[0]["t"]
    bucket = [ordered[0]]
    for a in ordered[1:]:
        if a["t"] - t1 <= config.merge_gap_s:
            t1 = a["t"]
            bucket.append(a)
        else:
            windows.append((t0, t1, bucket))
            t0 = t1 = a["t"]
            bucket = [a]
    windows.append((t0, t1, bucket))

    tenants = _tenants_from_rows(rows)
    critical_sets = _critical_sets(rows)
    incidents = [_attribute_window(i, w0, w1, ws, rows, fault_events,
                                   tenants, critical_sets, config)
                 for i, (w0, w1, ws) in enumerate(windows)]
    incidents.sort(key=lambda inc: (-inc.score, inc.t_start, inc.id))
    return incidents


def attribute(telemetry, faults=None,
              config: IncidentConfig = IncidentConfig()) -> List[Incident]:
    """Attribute a live ``Telemetry``'s alerts; the convenience entry.

    ``faults`` is the run's ``FaultPlan`` (or None).  When the telemetry
    is live, each incident is also dropped into the span tree as a linked
    ``incident`` span and the list is stored at ``telemetry.incidents``
    (so ``telemetry_rows`` / ``dump_jsonl`` export them).  Runs without
    monitors — or without alerts — attribute to an empty list.
    """
    health = getattr(telemetry, "health", None)
    alerts = [a.as_row() for a in health.alerts] if health is not None \
        else []
    rows = [s.as_row() for s in telemetry.trace.spans]
    events = faults.events() if faults is not None else []
    incidents = attribute_rows(rows, alerts, events, config)
    if getattr(telemetry, "enabled", False):
        for inc in incidents:
            inc.span = telemetry.trace.emit(
                f"incident:{inc.cause}", "incident", inc.t_start,
                inc.t_end, cause=inc.cause, score=round(inc.score, 6),
                n_alerts=inc.n_alerts,
                impact_dollars=inc.impact_dollars)
        telemetry.incidents = incidents
    return incidents


def incident_rows(incidents: Sequence[Incident]) -> List[dict]:
    return [inc.as_row() for inc in incidents]


def dump_incidents(incidents: Sequence[Incident], path) -> None:
    """Byte-stable incident JSONL (sorted keys) — the golden-fixture
    format: same seed + same FaultPlan => byte-identical file."""
    with open(path, "w") as f:
        for inc in incidents:
            f.write(json.dumps(inc.as_row(), sort_keys=True) + "\n")


def incident_table(rows_or_incidents) -> str:
    """Tabulate incidents (``Incident`` objects or ``kind: "incident"``
    JSONL rows, full exports welcome)."""
    from repro_torch.obs.export import format_table
    body = []
    for r in rows_or_incidents:
        if isinstance(r, Incident):
            r = r.as_row()
        if r.get("kind") != "incident":
            continue
        body.append((r["t_start"], r["t_end"], r["cause"], r["score"],
                     r["n_alerts"], r.get("tenant") or "",
                     r.get("phase") or "", r["impact_seconds"],
                     r["impact_dollars"]))
    return format_table(("t0(s)", "t1(s)", "cause", "score", "alerts",
                         "tenant", "phase", "impact_s", "impact_usd"),
                        body)
