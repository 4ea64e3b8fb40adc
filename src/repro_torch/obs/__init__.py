"""Fleet telemetry: only the reference's zero-overhead no-op ``NULL``
(``repro/obs/__init__.py``) so far; span tracing, metrics and exporters
wait for ROADMAP Queue 1 item 10.  ``NULL`` draws no randomness and reads
no clock, so it can never change a simulated (seconds, dollars) total."""
from __future__ import annotations


class _NullInstrument:
    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullMetrics:
    enabled = False

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT


class NullTracer:
    enabled = False

    def begin(self, name, kind, start, **attrs) -> int:
        return 0

    def end(self, span_id, end) -> None:
        pass

    def emit(self, name, kind, start, end, **attrs) -> int:
        return 0

    def set_attrs(self, span_id, **attrs) -> None:
        pass


class _NullTelemetry:
    enabled = False

    def __init__(self):
        self.trace = NullTracer()
        self.metrics = NullMetrics()


NULL = _NullTelemetry()

__all__ = ["NULL", "NullMetrics", "NullTracer"]
