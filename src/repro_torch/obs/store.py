"""Cross-run telemetry warehouse: an append-only JSONL store of per-run
summary records.

Every run emits rich telemetry, but without a store it evaporates at
process exit: ``BENCH_*.json`` is overwritten per run and nothing kept per-run
metric snapshots.  This module is the persistence layer on top — one
JSONL file, one summary record per line, keyed by::

    (name, backend, jax_version, git_sha, config_hash)

so records from different machines, jax versions, and commits coexist in
one history and can be queried back out.  Two record kinds:

  - ``kind: "run"`` (``run_record``) — built from a live ``Telemetry``:
    the metrics snapshot, per-phase time/dollar aggregates, per-iteration
    critical-path stats, straggler completion-tail quantiles
    (p50/p95/p99, exact — the registry keeps full samples), survivor
    counts per sketch round, health-monitor alerts, and the kernel
    wall-clock profiler's measured per-path timings.  The last two tables
    are exactly what the ROADMAP's kernel auto-router and analytic launch
    planner need: measured path timings and PAST iterations' survivor
    statistics.
  - ``kind: "bench"`` (``bench_record``) — built from a ``BENCH_*.json``
    payload (rows + meta); legacy payloads without ``git_sha`` /
    ``config_hash`` are backfilled with ``"unknown"``, the same
    convention the ``path`` field uses.

CLI (used by CI to maintain the bench history artifact)::

    python -m repro_torch.obs.store append BENCH_kernels.json \\
        --store artifacts/bench_history.jsonl
    python -m repro_torch.obs.store show --store artifacts/bench_history.jsonl
    python -m repro_torch.obs.store history --store ... --name kernels_bench \\
        --row fused_gram_oversketch

``repro_torch.obs.diff`` consumes the same store for history-aware regression
gating.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional

#: The identity fields every record carries; "unknown" when unavailable.
KEY_FIELDS = ("name", "backend", "jax_version", "git_sha", "config_hash")


def git_sha(cwd: Optional[str] = None) -> str:
    """Short git SHA of the working tree, or ``"unknown"`` outside a repo
    (or without git on PATH) — keys must never fail to stamp."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_hash(config: object) -> str:
    """Canonical 12-hex-digit hash of a JSON-able config blob.

    Canonical = sorted keys, minimal separators — the same dict hashes
    identically on any machine and Python, which is what makes the hash a
    usable cross-machine store/diff key.
    """
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


# ------------------------------------------------------------ record builders
def _tail_quantiles(hist) -> Dict[str, float]:
    return {"p50": hist.percentile(50), "p95": hist.percentile(95),
            "p99": hist.percentile(99), "count": hist.count}


def run_record(name: str, telemetry, *, backend: str = "unknown",
               jax_version: str = "unknown", sha: str = "unknown",
               cfg_hash: str = "unknown", extra: Optional[dict] = None
               ) -> dict:
    """Summarize one live ``Telemetry`` into a store record.

    Reads the registry directly (full histogram samples, so the tail
    quantiles are exact) plus the span tree for phase aggregates and the
    per-iteration critical-path attrs the optimizer attached.
    """
    from repro_torch.obs.export import phase_summary_rows

    reg = telemetry.metrics
    rec: dict = {"kind": "run", "name": name, "backend": backend,
                 "jax_version": jax_version, "git_sha": sha,
                 "config_hash": cfg_hash,
                 "metrics": reg.snapshot()}

    comp = reg.histograms.get("worker.completion_s")
    if comp is not None and comp.count:
        rec["straggler_tail"] = _tail_quantiles(comp)
    surv = reg.histograms.get("sketch.survivors")
    if surv is not None and surv.count:
        # Survivor counts per sketch round — the launch planner's
        # straggler-aware provisioning statistic (ROADMAP).
        rec["survivors"] = {"per_round": [float(v) for v in surv.values],
                            **_tail_quantiles(surv)}

    phase_rows = [s.as_row() for s in telemetry.trace.spans
                  if s.kind in ("phase", "charge")]
    if phase_rows:
        rec["phases"] = phase_summary_rows(phase_rows)

    cps = []
    for s in telemetry.trace.spans:
        if s.kind == "iteration" and "critical_path" in s.attrs:
            cps.append({"iteration": s.name,
                        "critical_path": list(s.attrs["critical_path"]),
                        "makespan": s.attrs.get("dag_makespan"),
                        "slack": s.attrs.get("slack", {})})
    if cps:
        rec["critical_paths"] = cps

    # Multi-tenant fleet aggregates (repro_torch.tenancy): job latency tail +
    # admission counters, present only when a JobScheduler drove the run.
    lat = reg.histograms.get("job.latency_s")
    if lat is not None and lat.count:
        rec["fleet_jobs"] = {"latency": _tail_quantiles(lat),
                             **{n.split(".", 1)[1]: c.value
                                for n, c in sorted(reg.counters.items())
                                if n.startswith("jobs.")}}
        qw = reg.histograms.get("job.queue_wait_s")
        if qw is not None and qw.count:
            rec["fleet_jobs"]["queue_wait"] = _tail_quantiles(qw)

    # Measured kernel wall-clock per path/op (ops.set_profiler hook) —
    # the table a data-driven fused_path() router reads.
    kernel_us = {n: h.summary() for n, h in sorted(reg.histograms.items())
                 if n.startswith("kernel.") and n.endswith(".us")}
    if kernel_us:
        rec["kernel_us"] = kernel_us
    kernel_paths = {n: c.value for n, c in sorted(reg.counters.items())
                    if n.startswith("kernel.path.")}
    if kernel_paths:
        rec["kernel_paths"] = kernel_paths

    health = getattr(telemetry, "health", None)
    if health is not None:
        rec["alerts"] = [a.as_row() for a in health.alerts]
        rec["health"] = health.summary()

    # Attributed incidents (repro_torch.obs.incident) and per-tenant SLO budget
    # state (repro_torch.obs.slo), when the run carried them — the cross-run
    # store is where "which cause recurs across commits?" gets answered.
    incidents = getattr(telemetry, "incidents", None)
    if incidents:
        rec["incidents"] = [inc.as_row() for inc in incidents]
    slo = getattr(telemetry, "slo", None)
    if slo is not None:
        rec["slo"] = slo.summary()

    if extra:
        rec.update(extra)
    return rec


def bench_record(payload: dict, *, sha: Optional[str] = None,
                 cfg_hash: Optional[str] = None) -> dict:
    """Summarize one ``BENCH_*.json`` payload (meta + rows) into a store
    record.  Meta fields missing from legacy payloads are backfilled with
    ``"unknown"`` so old baselines still key (as the ``path`` field does).
    """
    meta = dict(payload.get("meta", {}))
    rows = []
    for r in payload.get("rows", []):
        rows.append({"name": r["name"], "us": float(r["us"]),
                     "path": r.get("path", "unknown"),
                     "derived": r.get("derived", "")})
    return {"kind": "bench",
            "name": meta.get("module", "unknown"),
            "backend": meta.get("backend", "unknown"),
            "jax_version": meta.get("jax_version", "unknown"),
            "git_sha": sha if sha is not None
            else meta.get("git_sha", "unknown"),
            "config_hash": cfg_hash if cfg_hash is not None
            else meta.get("config_hash", "unknown"),
            "profile": meta.get("profile", "unknown"),
            "utc": meta.get("utc", "unknown"),
            "rows": rows}


# ----------------------------------------------------------------- the store
class Store:
    """Append-only JSONL warehouse of run/bench summary records."""

    def __init__(self, path):
        self.path = pathlib.Path(path)

    def append(self, record: dict) -> dict:
        missing = [k for k in KEY_FIELDS if k not in record]
        if missing:
            raise ValueError(f"record missing key fields {missing}")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
        return record

    def records(self, kind: Optional[str] = None, **filters) -> List[dict]:
        """All records, file order (= append order), optionally filtered
        by ``kind`` and exact key-field values (``name="kernels_bench"``)."""
        if not self.path.exists():
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if kind is not None and rec.get("kind") != kind:
                    continue
                if any(rec.get(k) != v for k, v in filters.items()):
                    continue
                out.append(rec)
        return out

    def latest(self, kind: Optional[str] = None, **filters
               ) -> Optional[dict]:
        recs = self.records(kind=kind, **filters)
        return recs[-1] if recs else None

    def last_two(self, kind: Optional[str] = None, **filters
                 ) -> Optional[tuple]:
        """(previous, latest) — the pair the regression gate diffs."""
        recs = self.records(kind=kind, **filters)
        return (recs[-2], recs[-1]) if len(recs) >= 2 else None

    def history(self, row: str, **filters) -> List[dict]:
        """Time series of one bench row across records: the perf
        trajectory for a single kernel/bench shape."""
        out = []
        for rec in self.records(kind="bench", **filters):
            for r in rec.get("rows", []):
                if r["name"] == row:
                    out.append({"git_sha": rec["git_sha"],
                                "utc": rec.get("utc", "unknown"),
                                "us": r["us"], "path": r["path"]})
        return out

    def kernel_path_table(self, name: str = "kernels_bench", **filters
                          ) -> Dict[str, dict]:
        """Latest measured per-row timings ``{row: {us, path}}`` — the
        persisted table the kernel auto-router consults instead of
        assuming the fused path always wins (ROADMAP: measured kernel
        auto-routing)."""
        rec = self.latest(kind="bench", name=name, **filters)
        if rec is None:
            return {}
        return {r["name"]: {"us": r["us"], "path": r["path"]}
                for r in rec.get("rows", [])}


# ----------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.store",
        description="append/inspect the cross-run bench+telemetry store")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_append = sub.add_parser("append", help="append a BENCH_*.json payload")
    p_append.add_argument("bench", help="BENCH_*.json file")
    p_append.add_argument("--store", required=True)
    p_append.add_argument("--git-sha", default=None,
                          help="override the payload's git_sha")

    p_show = sub.add_parser("show", help="list records")
    p_show.add_argument("--store", required=True)
    p_show.add_argument("--name", default=None)

    p_hist = sub.add_parser("history", help="one bench row's trajectory")
    p_hist.add_argument("--store", required=True)
    p_hist.add_argument("--name", required=True)
    p_hist.add_argument("--row", required=True)

    args = ap.parse_args(argv)
    store = Store(args.store)

    if args.cmd == "append":
        with open(args.bench) as f:
            payload = json.load(f)
        rec = store.append(bench_record(payload, sha=args.git_sha))
        print(f"appended {rec['name']} @ {rec['git_sha']} "
              f"({len(rec['rows'])} rows) -> {store.path}")
        return 0

    from repro_torch.obs.export import format_table
    if args.cmd == "show":
        filters = {} if args.name is None else {"name": args.name}
        recs = store.records(**filters)
        rows = [(r.get("kind"), r["name"], r["backend"], r["git_sha"],
                 r["config_hash"], r.get("utc", ""),
                 len(r.get("rows", [])) or len(r.get("phases", [])),
                 len(r.get("alerts", []))) for r in recs]
        print(format_table(("kind", "name", "backend", "git_sha",
                            "config_hash", "utc", "rows", "alerts"), rows))
        return 0

    if args.cmd == "history":
        hist = store.history(args.row, name=args.name)
        print(format_table(("git_sha", "utc", "us", "path"),
                           [(h["git_sha"], h["utc"], h["us"], h["path"])
                            for h in hist]))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
