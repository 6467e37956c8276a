"""Host-side span tracer of the port (twin of `repro.obs.tracer`), with
Chrome-trace/Perfetto JSON export.

Spans are wall-clock (`time.perf_counter_ns`) intervals around HOST-side
phases of a run: plan freeze, frozen-plan assembly, the one-shot prefill,
each decode step and each prefill chunk, the whole wave. The engine closes
a step's span at the loop's own blocking point (it reads the step's tokens
on the host anyway), so a span measures dispatch plus block, not device
kernel time, and adds no synchronisation. A CUDA graph capture falls inside
the span of the step that triggers it. Per-kernel attribution comes from
the labelled taps; spans answer "where did the wall-clock of this wave go".

Export is the Chrome trace-event JSON format ("traceEvents", `ph: "X"`
complete events, microsecond timestamps), loadable in Perfetto / chrome
about://tracing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional


class SpanTracer:
    """Append-only list of completed spans. Thread-safe; nested spans are
    reconstructed by the viewer from begin/duration overlap on the same
    (pid, tid) track, so `span()` needs no explicit parent bookkeeping."""

    def __init__(self, enabled: bool = True, process_name: str = "repro",
                 max_events: int = 200_000):
        self.enabled = enabled
        self.process_name = process_name
        self.max_events = max_events
        self.events: list = []
        self._lock = threading.Lock()
        self._epoch_ns = time.perf_counter_ns()

    def _emit(self, ev: dict):
        with self._lock:
            if len(self.events) < self.max_events:
                self.events.append(ev)

    @contextmanager
    def span(self, name: str, **args):
        """Time a host-side phase; extra kwargs become viewer-visible args."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            ev = {
                "name": name,
                "ph": "X",
                "ts": (t0 - self._epoch_ns) / 1e3,   # µs
                "dur": (t1 - t0) / 1e3,
                "pid": os.getpid(),
                "tid": threading.get_ident(),
            }
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            self._emit(ev)

    def add_complete(self, name: str, t0_ns: int, t1_ns: int, **args):
        """Record a span from explicit perf_counter_ns endpoints — for code
        whose natural end-of-interval is a later blocking point (the
        engine's decode loop blocks on step t's output at the top of
        iteration t+1, so the span closes there)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._emit(ev)

    def instant(self, name: str, **args):
        """Zero-duration marker (e.g. 'plans frozen')."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._emit(ev)

    def span_names(self) -> set:
        with self._lock:
            return {e["name"] for e in self.events}

    def chrome_trace(self) -> dict:
        """The trace document; `export(path)` writes it."""
        with self._lock:
            events = list(self.events)
        meta = [{
            "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
            "args": {"name": self.process_name},
        }]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


@contextmanager
def _null_span():
    yield


def maybe_span(tracer: Optional[SpanTracer], name: str, **args):
    """Span when a tracer is attached and enabled, no-op otherwise — lets
    instrumented code read as one line without None-checks at call sites."""
    if tracer is None or not tracer.enabled:
        return _null_span()
    return tracer.span(name, **args)
