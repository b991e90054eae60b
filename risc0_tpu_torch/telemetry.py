# The port's own copy of risc0_tpu/telemetry.py.
"""Cluster observability: spans + metrics (SURVEY §5; reference
r0vm/src/actors/mod.rs:39-46 initializes OTel tracing + an OTLP metrics
pipeline per process — this is the dependency-free equivalent).

Spans
-----
`tracer()` returns the process Tracer, the one recorder of the port.
`with tracer().span("prove", job=3):` opens a span; nesting links
parent/child via a thread-local context, and `ctx()` carries the context
across threads (the scheduler stamps each Task with the submitting job's
context, so a task's span parents to its job even though it runs on a
worker thread).  A span without a parent starts a trace: every span
under it shares its trace ID, so one request is one trace.

`boundary(name, **attrs)` opens a layer's span (prove, execute,
prove_segment, lift, self_check, ...) unless one of that name is already
open on the thread.  `perf.scope(name)` opens a scope span: scopes nest
into dotted paths (a.b.c) whose calls and seconds the recorder totals
for `perf.report()`; any other span starts a new path.

Times are `time.perf_counter_ns()`, the clock a device trace is tied to
on the host; `Span.to_otlp()` moves them to Unix nanoseconds by an
offset read once at import.  RISC0_TPU_PERF=0 turns the recorder off:
no span is opened and no clock is read.

Completed spans buffer in memory (ring, default 4096) and, when
RISC0_TPU_OTLP is set to a file path, stream one OTLP/JSON
`resourceSpans` object per line — the shape an OTLP/HTTP collector
accepts, so shipping is `curl --data-binary @file`-trivial.

Metrics
-------
Counters and histograms keyed by (name, labels).  `metrics().snapshot()`
returns plain dicts; `metrics().expose()` renders Prometheus text
exposition (served at GET /metrics by zkvm/api_server.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

ENABLED = os.environ.get("RISC0_TPU_PERF", "1") != "0"

# perf_counter_ns() + this = Unix nanoseconds (OTLP's clock)
_UNIX_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_ns: int
    attributes: dict = field(default_factory=dict)
    end_ns: int = 0
    status: str = "OK"
    thread: int = 0
    path: str | None = None  # a perf scope's dotted path; None otherwise

    def to_otlp(self) -> dict:
        """One span in OTLP/JSON shape (trace-api v1)."""
        def attr(k, v):
            if isinstance(v, bool):
                val = {"boolValue": v}
            elif isinstance(v, int):
                val = {"intValue": str(v)}
            elif isinstance(v, float):
                val = {"doubleValue": v}
            else:
                val = {"stringValue": str(v)}
            return {"key": k, "value": val}

        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            **({"parentSpanId": self.parent_id} if self.parent_id else {}),
            "name": self.name,
            "startTimeUnixNano": str(self.start_ns + _UNIX_OFFSET_NS),
            "endTimeUnixNano": str(self.end_ns + _UNIX_OFFSET_NS),
            "attributes": [attr(k, v) for k, v in self.attributes.items()],
            "status": {"code": 2 if self.status == "ERROR" else 1},
        }


class _SpanHandle:
    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def set(self, **attrs):
        self.span.attributes.update(attrs)

    def fail(self, error: Exception):
        """Mark the span failed by an exception it caught."""
        self.span.status = "ERROR"
        self.span.attributes["error"] = repr(error)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self.span.status = "ERROR"
            self.span.attributes.setdefault("error", repr(ev))
        self._tracer._end(self.span)
        return False


class _NoSpan:
    """What a span is while the recorder is off."""

    def set(self, **attrs):
        pass

    def fail(self, error: Exception):
        pass

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False


NO_SPAN = _NoSpan()


class Tracer:
    """Thread-local span stack + bounded completed-span buffer."""

    def __init__(self, service: str = "risc0_tpu", capacity: int = 4096):
        self.service = service
        self._local = threading.local()
        self._lock = threading.Lock()
        self._finished: deque[Span] = deque(maxlen=capacity)
        self._totals: dict[str, list] = {}  # scope path -> [calls, ns]
        self._sink_path = os.environ.get("RISC0_TPU_OTLP")

    # -- context plumbing ------------------------------------------------
    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def ctx(self) -> tuple | None:
        """(trace_id, span_id) of the active span, for cross-thread
        propagation (reference: OTel Context::current)."""
        st = self._stack()
        return (st[-1].trace_id, st[-1].span_id) if st else None

    def span(self, name: str, parent: tuple | None = None, **attrs):
        """Open a span.  `parent` overrides the thread-local parent —
        pass a Task's stamped ctx on worker threads."""
        if not ENABLED:
            return NO_SPAN
        return _SpanHandle(self, self._open(name, parent, attrs, None))

    def scope(self, name: str) -> _SpanHandle:
        """Open a perf scope's span: its path extends the innermost open
        span's if that is a scope too."""
        st = self._stack()
        path = (st[-1].path + "." + name if st and st[-1].path is not None
                else name)
        return _SpanHandle(self, self._open(name, None, {}, path))

    def _open(self, name, parent, attrs, path) -> Span:
        st = self._stack()
        if parent is None and st:
            trace_id, parent_id = st[-1].trace_id, st[-1].span_id
        elif parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = _new_id(16), None
        s = Span(name=name, trace_id=trace_id, span_id=_new_id(8),
                 parent_id=parent_id, start_ns=time.perf_counter_ns(),
                 attributes=attrs, thread=threading.get_ident(), path=path)
        st.append(s)
        return s

    def annotate(self, **attrs):
        """Set attributes on this thread's innermost open span, if any."""
        st = self._stack()
        if st:
            st[-1].attributes.update(attrs)

    def is_open(self, name: str) -> bool:
        """Whether a span of that name is open on this thread."""
        return any(s.name == name for s in self._stack())

    def _end(self, s: Span):
        s.end_ns = time.perf_counter_ns()
        st = self._stack()
        if st and st[-1] is s:
            st.pop()
        else:  # ended out of order (cross-thread): drop from wherever
            try:
                st.remove(s)
            except ValueError:
                pass
        with self._lock:
            self._finished.append(s)
            if s.path is not None:
                ent = self._totals.setdefault(s.path, [0, 0])
                ent[0] += 1
                ent[1] += s.end_ns - s.start_ns
        path = self._sink_path
        if path:
            line = json.dumps({"resourceSpans": [{
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": self.service}}]},
                "scopeSpans": [{"scope": {"name": "risc0_tpu"},
                                "spans": [s.to_otlp()]}],
            }]})
            with self._lock, open(path, "a") as f:
                f.write(line + "\n")

    # -- introspection ---------------------------------------------------
    def finished(self, name: str | None = None) -> list[Span]:
        with self._lock:
            out = list(self._finished)
        return [s for s in out if name is None or s.name == name]

    def totals(self) -> dict[str, tuple[int, float]]:
        """{scope path: (calls, total seconds)} since `reset_totals`."""
        with self._lock:
            return {k: (v[0], v[1] / 1e9) for k, v in self._totals.items()}

    def reset_totals(self):
        """Clear the scope totals only: open spans and the finished ring
        stay, so a caller may reset in the middle of a request."""
        with self._lock:
            self._totals.clear()

    def reset(self):
        with self._lock:
            self._finished.clear()
        self._sink_path = os.environ.get("RISC0_TPU_OTLP")


_HIST_BOUNDS = (0.001, 0.005, 0.025, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0,
                600.0, 3600.0)


class Metrics:
    """Counters + duration histograms, Prometheus-exposable."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._hists: dict[tuple, list] = {}  # key -> [buckets, sum, count]

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted(labels.items())))

    def inc(self, name: str, value: float = 1.0, **labels):
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def observe(self, name: str, seconds: float, **labels):
        k = self._key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = [[0] * (len(_HIST_BOUNDS) + 1), 0.0, 0]
            for i, b in enumerate(_HIST_BOUNDS):
                if seconds <= b:
                    h[0][i] += 1
                    break
            else:
                h[0][-1] += 1
            h[1] += seconds
            h[2] += 1

    def snapshot(self) -> dict:
        def fmt(k):
            name, labels = k
            return name + ("" if not labels else
                           "{" + ",".join(f"{a}={b}" for a, b in labels)
                           + "}")
        with self._lock:
            return {
                "counters": {fmt(k): v for k, v in self._counters.items()},
                "histograms": {fmt(k): {"sum": h[1], "count": h[2]}
                               for k, h in self._hists.items()},
            }

    def expose(self) -> str:
        """Prometheus text exposition format."""
        def labelstr(labels, extra=None):
            items = list(labels) + (extra or [])
            if not items:
                return ""
            return "{" + ",".join(f'{a}="{b}"' for a, b in items) + "}"

        lines = []
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name}{labelstr(labels)} {v}")
            for (name, labels), h in sorted(self._hists.items()):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for i, b in enumerate(_HIST_BOUNDS):
                    cum += h[0][i]
                    lines.append(f"{name}_bucket"
                                 f"{labelstr(labels, [('le', b)])} {cum}")
                cum += h[0][-1]
                lines.append(f"{name}_bucket"
                             f"{labelstr(labels, [('le', '+Inf')])} {cum}")
                lines.append(f"{name}_sum{labelstr(labels)} {h[1]}")
                lines.append(f"{name}_count{labelstr(labels)} {h[2]}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._hists.clear()


_tracer = Tracer()
_metrics = Metrics()


def tracer() -> Tracer:
    return _tracer


def boundary(name: str, **attrs):
    """Open the span of a layer boundary on the process tracer, unless one
    of that name is open on this thread already (a layer entered through
    another of its entry points)."""
    if not ENABLED or _tracer.is_open(name):
        return NO_SPAN
    return _tracer.span(name, **attrs)


def metrics() -> Metrics:
    return _metrics
