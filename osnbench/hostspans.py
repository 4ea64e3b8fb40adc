"""The program's own host spans and counters (``repro_torch.obs.host``),
read for the per-layer metrics of a traced run.

The program stamps its spans in ``time.time_ns()``, the clock of the
profiler's events, so the two windows of a traced run part at the traced
span's first device operation: the plain window's iterations are the last
``ctx["plain"]["iterations"]`` ``iteration`` spans that end before it, and
the traced span's spans are those that end after it.  The idle gaps of the
trace (``ctx["trace"]["gaps"]``: length, start, ...) are compared with the
spans directly.

A program without the tracer, or a ring that no longer holds a window's
spans, gives nothing to read: every function here then returns None.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Tuple


def tracer():
    """The program's host tracer in this process, or None."""
    try:
        from repro_torch.obs import host
    except ImportError:
        return None
    return host.TRACER


def _closed(spans) -> list:
    return [s for s in spans if not math.isnan(s.end)]


def _first_device_ns(ctx) -> Optional[int]:
    ops = ctx["trace"]["ops"]
    return min(o[1] for o in ops) if ops else None


def plain_window(ctx) -> Optional[Tuple[list, list]]:
    """The plain window's ``iteration`` spans and every span of those
    iterations, or None where they are missing or were dropped."""
    tr, t0 = tracer(), _first_device_ns(ctx)
    n = ctx["plain"]["iterations"]
    if tr is None or t0 is None or n <= 0:
        return None
    spans = _closed(tr.spans)
    its = [s for s in spans if s.name == "iteration" and s.end <= t0][-n:]
    # The ring drops the oldest first: with the window's first iteration
    # span still there, every later span is too.
    if len(its) < n:
        return None
    keys = {(s.call, s.iteration) for s in its}
    first = its[0].span_id
    members = [s for s in spans
               if s.span_id >= first and (s.call, s.iteration) in keys]
    return its, members


def traced_spans(ctx) -> Optional[list]:
    """Every span that ends after the traced span's first device
    operation, or None where the ring dropped any of them."""
    tr, t0 = tracer(), _first_device_ns(ctx)
    if tr is None or t0 is None or not tr.spans:
        return None
    if tr.dropped and tr.spans[0].start > t0:
        return None
    return [s for s in _closed(tr.spans) if s.end > t0]


def per_iteration_ms(ctx, name: str) -> Optional[float]:
    """Host ms an iteration inside ``name`` spans, plain window."""
    got = plain_window(ctx)
    if got is None:
        return None
    its, members = got
    ns = sum(s.end - s.start for s in members if s.name == name)
    return ns / 1e6 / len(its)


def union(intervals) -> List[Tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_ns(gaps, intervals) -> int:
    """Nanoseconds of the idle gaps ((length, start, ...) each) that lie
    inside the union of ``intervals``."""
    merged = union(intervals)
    starts = [s for s, _ in merged]
    total = 0
    for g in gaps:
        a, b = g[1], g[1] + g[0]
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(merged) and merged[i][0] < b:
            total += max(0, min(b, merged[i][1]) - max(a, merged[i][0]))
            i += 1
    return total


def leaf_segments(spans, label=None) -> List[Tuple[int, int, str]]:
    """(start, end, name) pieces of the host's timeline, each named by the
    innermost span open there (spans nest: one host thread), or by
    ``label(span)``."""
    label = label or (lambda s: s.name)
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        while stack and stack[-1][0] <= s.start:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack and t < s.start:
            out.append((t, s.start, stack[-1][1]))
        t = s.start
        stack.append((s.end, label(s)))
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle_by_leaf(ctx, label=None) -> Optional[Dict[str, float]]:
    """The traced span's device-idle ms an iteration, by the program's
    innermost span open at each instant of each gap ("none": no span), or
    by ``label(span)`` of it."""
    spans = traced_spans(ctx)
    if spans is None or not ctx["iterations"]:
        return None
    segs = leaf_segments(spans, label)
    starts = [s for s, _, _ in segs]
    out: Dict[str, float] = {}
    for g in ctx["trace"]["gaps"]:
        a, b = g[1], g[1] + g[0]
        covered = 0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            piece = min(b, segs[i][1]) - max(a, segs[i][0])
            if piece > 0:
                out[segs[i][2]] = out.get(segs[i][2], 0) + piece
                covered += piece
            i += 1
        out["none"] = out.get("none", 0) + (b - a) - covered
    return {k: v / 1e6 / ctx["iterations"] for k, v in out.items()}
