"""Request-scoped tracing for the serving runtime — the port's own copy of
``paddle_tpu/observability/trace.py`` (pure Python).

* ``Tracer`` — a bounded ring buffer of finished ``Span``s on an injectable
  clock, ``time.perf_counter`` by default.
* contextvar propagation — ``tracer.span(...)`` nests through
  ``contextvars``; across threads (HTTP handler -> queue -> tick loop)
  ``RequestTrace`` carries the (trace_id, root span) pair on the request
  object and records spans from whichever thread observed the interval.
* sampling — decided per TRACE at root creation; ``enabled=False`` makes
  the whole tracer a no-op.
* export — ``export_chrome`` emits complete "X" events;
  ``export_joined_chrome`` merges tracer spans with a finished
  ``torch.profiler.profile``'s events (host and device) on the tracer's
  ``perf_counter`` microsecond timebase, sorted by ``ts``.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager

__all__ = ["Span", "Tracer", "RequestTrace", "new_trace_id",
           "current_trace_id", "export_joined_chrome"]

# (trace_id, span_id) of the innermost open span in THIS context
_ctx: contextvars.ContextVar = contextvars.ContextVar("paddle_trace_ctx",
                                                      default=None)

_session = f"{os.getpid() & 0xFFFF:04x}{random.SystemRandom().randrange(16 ** 4):04x}"
_trace_seq = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique trace id: <pid+rand session>-<sequence>."""
    return f"{_session}-{next(_trace_seq):08x}"


def current_trace_id():
    """Trace id of the innermost open contextvar span, or None."""
    cur = _ctx.get()
    return cur[0] if cur is not None else None


class Span:
    """One finished (closed) interval in a trace."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name",
                 "start_us", "end_us", "tid", "tags")

    def __init__(self, trace_id, span_id, parent_id, name,
                 start_us, end_us, tid, tags):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_us = float(start_us)
        self.end_us = float(end_us)
        self.tid = tid
        self.tags = tags or {}

    @property
    def duration_us(self) -> float:
        return self.end_us - self.start_us

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"dur={self.duration_us:.1f}us, tags={self.tags})")


class Tracer:
    """Ring-buffer span store on an injectable clock.

    ``capacity`` bounds memory: the newest ``capacity`` spans are retained,
    older ones are dropped (counted in ``dropped``) — a tracer left on in a
    long-running server can never grow without bound.
    """

    def __init__(self, capacity=4096, clock=time.perf_counter,
                 sample_rate=1.0, enabled=True, rng=None):
        self.clock = clock
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self._rng = rng if rng is not None else random.Random(0x5EED)
        self._spans: deque[Span] = deque(maxlen=int(capacity))
        self._span_seq = itertools.count(1)
        self._lock = threading.Lock()
        self._recorded = 0

    # ------------------------------------------------------------------ time
    def now_us(self) -> float:
        """Current time in microseconds on the tracer clock (profiler-joined
        timebase when the default perf_counter clock is kept)."""
        return self.clock() * 1e6

    # ------------------------------------------------------------- decisions
    def should_sample(self) -> bool:
        """Per-TRACE sampling decision (call once at root creation)."""
        if not self.enabled:
            return False
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return self._rng.random() < self.sample_rate

    def new_span_id(self) -> str:
        return f"s{next(self._span_seq):06x}"

    # --------------------------------------------------------------- storage
    def record(self, name, start_us, end_us, trace_id, parent_id=None,
               span_id=None, tags=None, tid=None):
        """Record a closed span with explicit timestamps (the cross-thread
        path: the caller observed the interval, whichever thread that was).
        Returns the span id."""
        if not self.enabled:
            return None
        sid = span_id or self.new_span_id()
        span = Span(trace_id, sid, parent_id, name, start_us,
                    max(end_us, start_us),
                    tid if tid is not None else threading.get_ident(),
                    dict(tags) if tags else {})
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                pass  # deque evicts the oldest on append
            self._recorded += 1
            self._spans.append(span)
        return sid

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring buffer so far."""
        with self._lock:
            return max(0, self._recorded - len(self._spans))

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._recorded = 0

    # ------------------------------------------------------------- retrieval
    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def trace(self, trace_id) -> list:
        """All retained spans of one trace, in interval-containment order
        (by start time, enclosing spans before the spans they contain)."""
        return sorted((s for s in self.spans() if s.trace_id == trace_id),
                      key=lambda s: (s.start_us, -s.end_us))

    def trace_ids(self) -> list:
        seen: dict = {}
        for s in self.spans():
            seen.setdefault(s.trace_id, None)
        return list(seen)

    # ------------------------------------------------------------ contextvar
    @contextmanager
    def span(self, name, trace_id=None, **tags):
        """Contextvar-nested span for single-threaded instrumentation::

            with tracer.span("load"):
                with tracer.span("read_shard", shard=3):
                    ...

        A new trace id is minted when there is no enclosing span and none is
        passed. Exceptions are tagged (``error=repr(exc)``) and re-raised."""
        cur = _ctx.get()
        if trace_id is None:
            trace_id = cur[0] if cur is not None else new_trace_id()
        parent_id = cur[1] if (cur is not None and cur[0] == trace_id) else None
        sid = self.new_span_id()
        token = _ctx.set((trace_id, sid))
        start = self.now_us()
        try:
            yield trace_id
        except BaseException as e:
            tags = dict(tags)
            tags["error"] = repr(e)
            raise
        finally:
            _ctx.reset(token)
            self.record(name, start, self.now_us(), trace_id,
                        parent_id=parent_id, span_id=sid, tags=tags)

    # ---------------------------------------------------------------- export
    def chrome_events(self) -> list:
        """Complete-event ("X") dicts on the shared profiler timebase."""
        pid = os.getpid()
        out = []
        for s in self.spans():
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            args.update(s.tags)
            out.append({"name": s.name, "ph": "X", "cat": "serving",
                        "ts": s.start_us, "dur": s.duration_us,
                        "pid": pid, "tid": s.tid, "args": args})
        out.sort(key=lambda e: e["ts"])
        return out

    def export_chrome(self, path=None):
        """Write (or return) a chrome://tracing JSON of all retained spans."""
        doc = {"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}
        if path is None:
            return doc
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


class RequestTrace:
    """Trace handle that rides a serving request across threads.

    contextvars do not flow HTTP-handler → queue → batcher thread, so the
    request object carries this instead: the root span opens at admission,
    children are recorded (with explicit timestamps) by whichever thread
    observed the interval, and exactly one ``finish(outcome)`` closes the
    root — mirroring the terminal-outcome CAS, whose winner tags the
    terminal span."""

    __slots__ = ("tracer", "trace_id", "root_id", "t0_us", "_done")

    def __init__(self, tracer, trace_id=None, sampled=None):
        if sampled is None:
            sampled = tracer.should_sample() if tracer is not None else False
        self.tracer = tracer if (tracer is not None and sampled
                                 and tracer.enabled) else None
        self.trace_id = trace_id or new_trace_id()
        self.root_id = (self.tracer.new_span_id()
                        if self.tracer is not None else None)
        self.t0_us = self.tracer.now_us() if self.tracer is not None else 0.0
        self._done = False

    @property
    def sampled(self) -> bool:
        return self.tracer is not None

    def now_us(self) -> float:
        return self.tracer.now_us() if self.tracer is not None else 0.0

    def child(self, name, start_us, end_us, **tags):
        """Record a closed child-of-root span from explicit timestamps."""
        if self.tracer is None:
            return
        self.tracer.record(name, start_us, end_us, self.trace_id,
                           parent_id=self.root_id, tags=tags)

    def event(self, name, **tags):
        """Zero-duration point event under the root span."""
        if self.tracer is None:
            return
        t = self.tracer.now_us()
        self.tracer.record(name, t, t, self.trace_id,
                           parent_id=self.root_id, tags=tags)

    @contextmanager
    def span(self, name, **tags):
        """Child span over a with-block (same-thread intervals)."""
        if self.tracer is None:
            yield self
            return
        start = self.tracer.now_us()
        try:
            yield self
        finally:
            self.child(name, start, self.tracer.now_us(), **tags)

    def finish(self, outcome, **tags):
        """Terminal: record the outcome-tagged terminal span and close the
        root. Idempotent — only the first caller (the CAS winner's path)
        records; later calls are no-ops."""
        if self.tracer is None or self._done:
            return False
        self._done = True
        end = self.tracer.now_us()
        self.tracer.record(outcome, end, end, self.trace_id,
                           parent_id=self.root_id,
                           tags={"outcome": outcome, **tags})
        self.tracer.record("request", self.t0_us, end, self.trace_id,
                           span_id=self.root_id,
                           tags={"outcome": outcome, **tags})
        return True


def _profiler_events(profiler, start_us=None):
    """Complete-event ("X") dicts of a finished ``torch.profiler.profile``
    on the tracer's ``perf_counter`` microsecond timebase.

    The profiler stamps its events relative to the trace start, which it
    keeps in nanoseconds since the epoch; ``start_us`` (the trace start on
    the ``perf_counter`` clock) defaults to that epoch stamp moved onto
    ``perf_counter`` by one reading of both clocks. Device kernels carry
    ``cat`` "device", host operators "host"."""
    if start_us is None:
        start_ns = profiler.profiler.kineto_results.trace_start_ns()
        start_us = (start_ns / 1e3
                    - (time.time() - time.perf_counter()) * 1e6)
    out = []
    for ev in profiler.events():
        dev = str(getattr(ev, "device_type", "")).endswith("CUDA")
        out.append({"name": ev.name, "ph": "X",
                    "ts": start_us + ev.time_range.start,
                    "dur": max(0.0, ev.time_range.elapsed_us()),
                    "pid": "device" if dev else "host",
                    "tid": int(getattr(ev, "thread", 0) or 0),
                    "cat": "device" if dev else "host"})
    return out


def export_joined_chrome(path, tracer=None, profiler=None, extra_events=(),
                         profiler_start_us=None):
    """Merge tracer spans and a finished ``torch.profiler.profile``'s events
    into one chrome trace (``_profiler_events``), sorted by ``ts``:
    serving spans, ``record_function`` ranges and device kernels on one
    timeline. ``path`` None returns the document instead of writing it."""
    events = []
    if tracer is not None:
        events.extend(tracer.chrome_events())
    if profiler is not None:
        events.extend(_profiler_events(profiler, profiler_start_us))
    events.extend(extra_events)
    events.sort(key=lambda e: e.get("ts", 0.0))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is None:
        return doc
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
