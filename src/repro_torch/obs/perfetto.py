"""Chrome-trace / Perfetto JSON export of a recorded span tree.

``to_perfetto`` converts the tracer's spans into the Trace Event Format
(the JSON Perfetto and ``chrome://tracing`` both load): open
https://ui.perfetto.dev and drop the file in.  Timestamps are the
simulated clock in microseconds.

Track layout — what you see when the file opens:

  - **pid 1 "master"**: tid 1 carries the run + iteration slices (they
    nest); phases live on ``phases`` lanes (tid 10+), greedily packed so
    overlapping phases — the gradient chain running concurrently with the
    Hessian-sketch fan-out — land on *different* lanes and the overlap is
    visually inspectable.  Same for charge spans.
  - **pid 2 "workers"**: one tid per worker track (an attempt span's
    ``track`` label, e.g. ``"hessian/w7"``), allocated in first-seen
    order.  Each track shows that worker's lifecycle slices: ``cold``,
    ``run``, ``failed`` and ``retry`` attempts, speculative/hedged
    ``relaunch`` copies.

  - **pid 3 "counters"** (opt-in): Perfetto counter tracks (``ph: "C"``)
    rendered as area charts above the timeline — warm-pool hit rate,
    straggler-tail p95, per-tenant dollars, SLO burn gauges.  Pass the
    ``counters`` mapping (``counter_series`` builds it from a live
    telemetry's timestamped gauge points); the default export omits them
    entirely, so the committed golden trace stays byte-identical.

Serialization is byte-stable (``dumps_stable``: sorted keys, minimal
separators, floats via ``repr``) so a committed golden export can be
compared bytes-for-bytes forever; ``validate_trace`` is the schema check
CI runs against every exported trace (no negative durations, phase slices
present, worker tracks non-empty, counter samples well-formed).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.span import Span

MASTER_PID = 1
WORKERS_PID = 2
COUNTERS_PID = 3          # counter tracks (opt-in)
MASTER_TID = 1            # run + iteration slices
PHASE_TID0 = 10           # first phase lane


def _us(seconds: float) -> float:
    return float(seconds) * 1e6


def _lane_pack(spans: Sequence[Span]) -> Dict[int, int]:
    """Greedy interval packing: span_id -> lane index.  Overlapping spans
    get distinct lanes; processing order (start, span_id) is deterministic."""
    lanes: List[float] = []       # lane -> last occupied end time
    out: Dict[int, int] = {}
    for s in sorted(spans, key=lambda s: (s.start, s.span_id)):
        for i, busy_until in enumerate(lanes):
            if s.start >= busy_until:
                lanes[i] = s.end
                out[s.span_id] = i
                break
        else:
            out[s.span_id] = len(lanes)
            lanes.append(s.end)
    return out


def counter_series(telemetry,
                   include_histograms: Sequence[str] = ("phase.tail_p95_s",)
                   ) -> Dict[str, List[Tuple[float, float]]]:
    """Build ``to_perfetto``'s ``counters`` mapping from a telemetry's
    timestamped instrument points.

    Every gauge that recorded ``(t, value)`` points (the registry's
    ``timesource`` must have been wired, which ``Telemetry`` does by
    default) becomes one counter track; histograms named in
    ``include_histograms`` contribute their raw observation stream too
    (the straggler tail as a sawtooth).  Names are sorted, points are in
    recording order — deterministic for a deterministic run.
    """
    out: Dict[str, List[Tuple[float, float]]] = {}
    metrics = getattr(telemetry, "metrics", None)
    if metrics is None:
        return out
    for name, g in sorted(getattr(metrics, "gauges", {}).items()):
        if g.points:
            out[name] = list(g.points)
    for name in include_histograms:
        h = getattr(metrics, "histograms", {}).get(name)
        if h is not None and h.points:
            out[name] = list(h.points)
    return out


def to_perfetto(spans: Iterable[Span],
                counters: Optional[Dict[str, Sequence[Tuple[float, float]]]]
                = None) -> dict:
    """Render spans as a Trace Event Format dict (see module docstring).

    ``counters`` optionally maps track name -> ``(t_seconds, value)``
    samples, emitted as ``ph: "C"`` counter events on pid 3.  Omitted by
    default so the plain span export is unchanged byte-for-byte.
    """
    spans = list(spans)
    events: List[dict] = []

    def meta(pid: int, tid: Optional[int], name: str, which: str) -> None:
        ev = {"ph": "M", "pid": pid, "name": which,
              "args": {"name": name}}
        if tid is not None:
            ev["tid"] = tid
        events.append(ev)

    meta(MASTER_PID, None, "master", "process_name")
    meta(MASTER_PID, MASTER_TID, "run", "thread_name")
    meta(WORKERS_PID, None, "workers", "process_name")

    def slice_event(s: Span, pid: int, tid: int) -> dict:
        ev = {"name": s.name, "cat": s.kind, "ph": "X",
              "ts": _us(s.start), "dur": _us(s.duration),
              "pid": pid, "tid": tid}
        if s.attrs:
            ev["args"] = s.attrs
        return ev

    # Master timeline: run + iteration slices nest on one tid.
    for s in spans:
        if s.kind in ("run", "iteration"):
            events.append(slice_event(s, MASTER_PID, MASTER_TID))

    # Phase lanes: pack so concurrent phases are side by side.
    phase_spans = [s for s in spans if s.kind in ("phase", "charge")]
    lanes = _lane_pack(phase_spans)
    for lane in sorted(set(lanes.values())):
        meta(MASTER_PID, PHASE_TID0 + lane, f"phases lane {lane}",
             "thread_name")
    for s in phase_spans:
        events.append(slice_event(s, MASTER_PID, PHASE_TID0 + lanes[s.span_id]))

    # Worker tracks: one tid per distinct track label, first-seen order.
    track_tid: Dict[str, int] = {}
    for s in spans:
        if s.kind != "attempt" or s.track is None:
            continue
        if s.track not in track_tid:
            track_tid[s.track] = 1 + len(track_tid)
            meta(WORKERS_PID, track_tid[s.track], s.track, "thread_name")
        events.append(slice_event(s, WORKERS_PID, track_tid[s.track]))

    # Counter tracks (opt-in): one ph "C" stream per metric name.
    if counters:
        meta(COUNTERS_PID, None, "counters", "process_name")
        for name in sorted(counters):
            for t, v in counters[name]:
                events.append({"name": name, "cat": "counter", "ph": "C",
                               "ts": _us(t), "pid": COUNTERS_PID, "tid": 0,
                               "args": {"value": float(v)}})

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dumps_stable(trace: dict) -> str:
    """Deterministic serialization: byte-identical for identical spans."""
    return json.dumps(trace, sort_keys=True, separators=(",", ":")) + "\n"


def dump(trace: dict, path) -> None:
    with open(path, "w") as f:
        f.write(dumps_stable(trace))


def validate_trace(trace: dict, require_phases: Sequence[str] = (),
                   require_worker_tracks: bool = True,
                   require_counters: Sequence[str] = ()) -> None:
    """Schema check for an exported trace; raises ValueError on violation.

    Checks the trace-event invariants Perfetto needs (every slice has a
    name/pid/tid, no negative timestamp or duration; every counter sample
    a name/pid/ts and a numeric ``args.value``) plus the fleet-shape
    expectations CI asserts: the named phases are present as phase
    slices, at least one worker-lifecycle track is non-empty, and the
    named counter tracks carry at least one sample each.
    """
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents list")
    phase_names = set()
    counter_names = set()
    worker_slices = 0
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        if ph == "C":
            for field in ("name", "pid", "ts"):
                if field not in ev:
                    problems.append(f"counter event {i}: missing {field!r}")
            if ev.get("ts", 0) < 0:
                problems.append(f"counter event {i} ({ev.get('name')}): "
                                "negative ts")
            value = (ev.get("args") or {}).get("value")
            if not isinstance(value, (int, float)):
                problems.append(f"counter event {i} ({ev.get('name')}): "
                                "args.value is not numeric")
            counter_names.add(ev.get("name"))
            continue
        if ph != "X":
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        for field in ("name", "pid", "tid", "ts", "dur"):
            if field not in ev:
                problems.append(f"event {i}: missing {field!r}")
        if ev.get("ts", 0) < 0:
            problems.append(f"event {i} ({ev.get('name')}): negative ts")
        if ev.get("dur", 0) < 0:
            problems.append(f"event {i} ({ev.get('name')}): negative dur")
        if ev.get("cat") == "phase":
            phase_names.add(ev.get("name"))
        if ev.get("pid") == WORKERS_PID:
            worker_slices += 1
    for want in require_phases:
        if want not in phase_names:
            problems.append(f"required phase slice {want!r} not in trace "
                            f"(saw {sorted(phase_names)})")
    for want in require_counters:
        if want not in counter_names:
            problems.append(f"required counter track {want!r} not in trace "
                            f"(saw {sorted(counter_names)})")
    if require_worker_tracks and worker_slices == 0:
        problems.append("no worker-lifecycle slices (pid 2 is empty)")
    if problems:
        raise ValueError("invalid Perfetto trace:\n  "
                         + "\n  ".join(problems))


def validate_file(path, require_phases: Sequence[str] = (),
                  require_worker_tracks: bool = True,
                  require_counters: Sequence[str] = ()) -> dict:
    """Load + validate an exported trace file; returns the parsed dict."""
    with open(path) as f:
        trace = json.load(f)
    validate_trace(trace, require_phases=require_phases,
                   require_worker_tracks=require_worker_tracks,
                   require_counters=require_counters)
    return trace
