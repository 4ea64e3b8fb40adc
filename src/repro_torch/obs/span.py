"""Hierarchical span tracer on the simulated clock.

A span is one timed thing that happened on the simulated timeline: the
whole run, one Newton/GIANT iteration, one DAG phase, or one per-worker
lifecycle slice (cold start / running / retry / failed attempt).  Spans
form a tree through ``parent_id``: the optimizer opens run and iteration
spans with ``begin``/``end`` (the tracer keeps an open-span stack, so
anything emitted in between — the fleet engine's phase and attempt spans —
parents itself automatically), while completed intervals whose start and
end are both known at emission time go through ``emit``.

All timestamps are *simulated seconds* (the fleet engine's clock), which
is the whole point: the tracer never reads a wall clock and never draws
randomness, so attaching it cannot perturb a run.  ``NullTracer`` is the
zero-overhead default — every method is a constant-time no-op, and
``enabled`` lets instrumentation sites skip even building attribute dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional


#: Span kinds, outermost first.  ``track`` is only meaningful for
#: worker-lifecycle kinds (it names the Perfetto worker track).  ``alert``
#: spans are zero-duration markers the health monitors drop into the tree
#: at the simulated instant an anomaly was detected; ``job`` spans cover a
#: tenant job's arrival-to-finish interval (``repro_torch.tenancy``); and
#: ``incident`` spans cover an attributed alert window (``repro_torch.obs.
#: incident``), linking the ranked cause back to the timeline.  The
#: Perfetto exporter skips alert/job/incident kinds (they live in the
#: JSONL export, the report tables, and the HTML console).
KINDS = ("run", "iteration", "phase", "charge", "attempt", "alert", "job",
         "incident")


@dataclasses.dataclass
class Span:
    """One closed interval on the simulated timeline."""

    span_id: int
    parent_id: int                 # 0 = root (no parent)
    name: str
    kind: str                      # one of KINDS
    start: float                   # simulated seconds
    end: float                     # NaN while still open
    track: Optional[str] = None    # worker-track label (attempt spans)
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start

    def as_row(self) -> dict:
        """JSONL-ready dict (stable key order via sorted serialization)."""
        row = {"kind": "span", "id": self.span_id, "parent": self.parent_id,
               "name": self.name, "span_kind": self.kind,
               "start": float(self.start), "end": float(self.end)}
        if self.track is not None:
            row["track"] = self.track
        if self.attrs:
            row["attrs"] = self.attrs
        return row


class SpanTracer:
    """Collects spans; hierarchy comes from an explicit open-span stack."""

    enabled = True

    def __init__(self):
        self.spans: List[Span] = []
        self._by_id: Dict[int, Span] = {}
        self._stack: List[int] = []
        self._next_id = 1
        # High-water mark of every timestamp seen so far (simulated
        # seconds).  Consumers that observe the run through side channels —
        # the health monitors watch the metrics stream, which carries no
        # clock — stamp their records with this instead of guessing.
        self.last_time = 0.0

    # ------------------------------------------------------------ hierarchy
    @property
    def current(self) -> int:
        """Innermost open span id (0 when nothing is open)."""
        return self._stack[-1] if self._stack else 0

    def begin(self, name: str, kind: str, start: float, **attrs) -> int:
        """Open a span; children emitted before ``end`` parent under it."""
        sid = self._next_id
        self._next_id += 1
        span = Span(span_id=sid, parent_id=self.current, name=name,
                    kind=kind, start=float(start), end=math.nan,
                    attrs=dict(attrs))
        self.spans.append(span)
        self._by_id[sid] = span
        self._stack.append(sid)
        if span.start > self.last_time:
            self.last_time = span.start
        return sid

    def end(self, span_id: int, end: float) -> None:
        """Close an open span.  Closing out of order closes every span
        opened after it too (crash-robust unwinding)."""
        if span_id not in self._by_id:
            raise KeyError(f"unknown span id {span_id}")
        if float(end) > self.last_time:
            self.last_time = float(end)
        while self._stack:
            sid = self._stack.pop()
            self._by_id[sid].end = float(end)
            if sid == span_id:
                return
        raise ValueError(f"span {span_id} is not open")

    def emit(self, name: str, kind: str, start: float, end: float, *,
             parent: Optional[int] = None, track: Optional[str] = None,
             **attrs) -> int:
        """Record a completed span (start and end already known)."""
        sid = self._next_id
        self._next_id += 1
        span = Span(span_id=sid, parent_id=self.current if parent is None
                    else parent, name=name, kind=kind, start=float(start),
                    end=float(end), track=track, attrs=dict(attrs))
        self.spans.append(span)
        self._by_id[sid] = span
        if math.isfinite(span.end) and span.end > self.last_time:
            self.last_time = span.end
        return sid

    def set_attrs(self, span_id: int, **attrs) -> None:
        """Attach/overwrite attributes on an already-created span."""
        self._by_id[span_id].attrs.update(attrs)

    # -------------------------------------------------------------- queries
    def by_kind(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    def children(self, span_id: int) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span_id]


class NullTracer:
    """Zero-overhead tracer: the default when no telemetry is attached.

    Every method returns immediately; ``begin``/``emit`` return span id 0
    so call sites never branch on whether telemetry is live.  Draws no
    randomness and reads no clock — attaching or detaching a tracer can
    never change a simulated ``(seconds, dollars)`` total.
    """

    enabled = False
    spans: List[Span] = []          # always empty; shared sentinel is fine
    current = 0
    last_time = 0.0

    def begin(self, name, kind, start, **attrs) -> int:
        return 0

    def end(self, span_id, end) -> None:
        pass

    def emit(self, name, kind, start, end, *, parent=None, track=None,
             **attrs) -> int:
        return 0

    def set_attrs(self, span_id, **attrs) -> None:
        pass

    def by_kind(self, kind) -> List[Span]:
        return []

    def children(self, span_id) -> List[Span]:
        return []
