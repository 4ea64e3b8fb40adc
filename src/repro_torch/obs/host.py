"""Host spans and counters of the port's own layers, on the clock that
``torch.profiler`` stamps its events in.

The fleet telemetry (``obs.Telemetry``) stamps *simulated* seconds; this
tracer stamps what the host did: ``time.time_ns()``, the Unix-epoch
nanoseconds of the profiler's trace events, so a span and the device
operations and idle gaps of a trace taken over it can be compared
directly.  ``HostTracer`` is the ``SpanTracer`` hierarchy (name, kind,
start, end, parent from the open-span stack) kept in a bounded ring: the
newest ``capacity`` spans stay, and ``dropped`` counts the rest.  Its
``metrics`` registry holds the counters.  Spans of one solver call share
its ``call`` id, and spans of one iteration its ``iteration`` number.

One process-wide instance, ``TRACER``, always records: a span costs two
clock reads and an append.  While a profiler is active each span also
opens a ``record_function`` range named ``repro_torch.<name>``, so an
exported trace shows the program's layers.  Nothing here enters an
``obs.Telemetry``: the simulated-clock spans and metrics stay as they were.
The tracer takes no lock: spans come from the thread that runs the solver.

Spans (``name``; the kind is the same word):

  call         ``core.newton.oversketched_newton``, the whole call
  encode       ``CodedMatvecEngine.__init__``: the product-code encodes
  iteration    one Newton iteration, from the key split to its tail's end
  gradient     one coded (tag X or XT) or exact (tag exact) gradient product
  hessian      ``_hessian_phase``: A, the fleet round, the draws, the Gram
  sketch_gram  the sketch -> Gram call (``fused``: the family's fused kernel)
  direction    ``_solve_direction``
  linesearch   the line search and its fleet dispatch
  fleet        ``runtime.FleetEngine.run_phase`` and ``charge``: host work
  sync         a blocking read of a tensor's value by the host (``site``)
  tail         from the step ``w + step * p`` to the end of the iteration

Counters: ``host.syncs`` (one a ``sync`` span), ``host.h2d_pageable_copies``
and ``host.h2d_pageable_bytes`` (each blocking copy of a host-made tensor
or scalar to a device: ``to_device``, ``copied``).  An ``iteration`` or
``call`` span records under each counter's name what it added meanwhile.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from typing import Deque, Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.span import Span, SpanTracer

PREFIX = "repro_torch."
SYNCS = "host.syncs"
H2D_COPIES = "host.h2d_pageable_copies"
H2D_BYTES = "host.h2d_pageable_bytes"
COUNTERS = (SYNCS, H2D_COPIES, H2D_BYTES)
#: Spans whose attributes get the counters' increments.
COUNTED = ("call", "iteration")
_now = time.time_ns


@dataclasses.dataclass
class HostSpan(Span):
    """A span on the host's clock: ``start`` and ``end`` in Unix-epoch
    nanoseconds, ``end`` NaN while open."""

    call: int = 0           # the solver call's id; 0 outside any call
    iteration: int = -1     # the iteration number; -1 outside one


class _Scope:
    """``with tracer.span(...)``: the span is open inside the block."""

    __slots__ = ("tracer", "name", "attrs", "sid")

    def __init__(self, tracer: "HostTracer", name: str, attrs: dict):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self) -> "_Scope":
        self.sid = self.tracer._open(self.name, self.attrs)
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer.end(self.sid)
        return False


class HostTracer(SpanTracer):
    """Host spans in a ring of ``capacity``, counters in ``metrics``.  The
    open-span stack holds the open spans themselves."""

    def __init__(self, capacity: int = 1 << 16):
        super().__init__()
        self.spans: Deque[HostSpan] = collections.deque(maxlen=capacity)
        self.metrics = MetricsRegistry()
        self._syncs, self._copies, self._bytes = (
            self.metrics.counter(k) for k in COUNTERS)
        self.appended = 0
        self._calls = 0
        self._ranges: Dict[int, object] = {}    # span id -> open range
        self._counts: Dict[int, tuple] = {}     # span id -> counters at begin

    @property
    def dropped(self) -> int:
        """Spans pushed out of the ring by newer ones."""
        return self.appended - len(self.spans)

    @property
    def current(self) -> int:
        return self._stack[-1].span_id if self._stack else 0

    def open_spans(self) -> list:
        """The open spans, outermost first."""
        return list(self._stack)

    def counts(self) -> tuple:
        """The counters' values, in ``COUNTERS``' order."""
        return self._syncs.value, self._copies.value, self._bytes.value

    # ------------------------------------------------------------ spans
    def begin(self, name: str, kind: Optional[str] = None,
              start: Optional[int] = None, **attrs) -> int:
        """Open a span now; children opened before ``end`` parent under
        it.  An ``iteration`` span takes its number from ``attrs["t"]``."""
        return self._open(name, attrs, kind, start)

    def _open(self, name: str, attrs: dict, kind: Optional[str] = None,
              start: Optional[int] = None) -> int:
        stack = self._stack
        sid = self._next_id
        self._next_id = sid + 1
        if stack:
            parent = stack[-1]
            pid, call, it = parent.span_id, parent.call, parent.iteration
        else:
            pid, call, it = 0, 0, -1
        if name == "call":
            self._calls += 1
            call, it = self._calls, -1
        elif name == "iteration":
            it = attrs["t"]
        if name in COUNTED:
            self._counts[sid] = self.counts()
        if _autograd_profiler._is_profiler_enabled:
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._ranges[sid] = rf
        # positional: a third of the keyword form's cost
        span = HostSpan(sid, pid, name, kind or name,
                        _now() if start is None else start,
                        math.nan, None, attrs, call, it)
        self.spans.append(span)
        self.appended += 1
        stack.append(span)
        return sid

    def end(self, span_id: int, end: Optional[int] = None) -> None:
        """Close an open span now.  Closing out of order closes every span
        opened after it too, at the same time."""
        t = _now() if end is None else end
        stack = self._stack
        if not stack or (stack[-1].span_id != span_id and not any(
                s.span_id == span_id for s in stack)):
            raise KeyError(f"span {span_id} is not open")
        while True:
            span = stack.pop()
            span.end = t
            sid = span.span_id
            if sid in self._counts:
                for k, was, now in zip(COUNTERS, self._counts.pop(sid),
                                       self.counts()):
                    span.attrs[k] = now - was
            if self._ranges and sid in self._ranges:
                self._ranges.pop(sid).__exit__(None, None, None)
            if sid == span_id:
                return

    def emit(self, *args, **kwargs) -> int:
        raise TypeError("host spans are opened and closed, not emitted")

    def set_attrs(self, span_id: int, **attrs) -> None:
        """Set attributes of the open span ``span_id``."""
        for s in self._stack:
            if s.span_id == span_id:
                s.attrs.update(attrs)
                return
        raise KeyError(f"span {span_id} is not open")

    def span(self, name: str, **attrs) -> _Scope:
        """A context manager: the span ``name`` is open inside the block."""
        return _Scope(self, name, attrs)

    def traced(self, name: str):
        """Decorator: each call of the function runs inside a span
        ``name``; the body adds attributes with ``annotate``."""
        def wrap(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                sid = self._open(name, {})
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.end(sid)
            return inner
        return wrap

    def annotate(self, **attrs) -> None:
        """Set attributes of the innermost open span."""
        if self._stack:
            self._stack[-1].attrs.update(attrs)

    # ------------------------------------------------ syncs and copies
    def sync(self, site: str) -> _Scope:
        """A context manager around one blocking read of a tensor's value
        by the host: a ``sync`` span named by ``site``, counted."""
        self._syncs.value += 1      # no listener: the registry is this one's
        return _Scope(self, "sync", {"site": site})

    def copied(self, device, nbytes: int, copies: int = 1) -> None:
        """Count ``copies`` blocking copies of ``nbytes`` in all from the
        host's pageable memory to ``device``, unless it is the host."""
        if not isinstance(device, torch.device):
            device = torch.device(device)
        if device.type != "cpu":
            self._copies.value += copies
            self._bytes.value += nbytes

    def to_device(self, t: torch.Tensor, device) -> torch.Tensor:
        """``t.to(device)`` for a tensor made on the host, counted."""
        self.copied(device, t.numel() * t.element_size())
        return t.to(device)


#: The process-wide host tracer.
TRACER = HostTracer()
