"""Span tracing: context manager and decorator, a thread-local stack, a
bounded ring, Chrome trace-event JSON (counterpart of
`deeplearning4j_tpu/observability/tracing.py:39-271`, with a plain
`threading.Lock` where the reference takes a traced lock).

Answers what nested inside what, and when: fit -> iteration ->
checkpoint.write, or serving.batch beside a request's span on another
thread. `export_chrome()` is the Chrome trace-event format (`ph`, `ts`,
`dur`, `pid`, `tid`, `args`), which Perfetto (ui.perfetto.dev) and
`chrome://tracing` load; a server serves it at `GET /api/trace`.

The buffer is a bounded `deque`: a long-running process keeps the last
`max_events` (`DL4J_TPU_TRACE_BUFFER`, 16384) events. A span is two
`perf_counter_ns` reads and one append, host time only: no span waits
for the device. `DL4J_TPU_OBS_SAMPLE_EVERY` thins the per-iteration
spans (`observability.iteration_span`).

Cross-process spans (`propagate.py`): a span opened with ``span_ctx=``
takes that context's (trace_id, span_id); one opened with
``parent_ctx=`` gets a fresh span id under a remote parent; the ids land
in the event's ``args``. ``epochUnixUs`` in `export_chrome` is the wall
clock at the tracer's perf_counter epoch, so timelines of several
processes line up.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.observability import propagate as _prop


class _NoopSpan:
    """Shared reusable no-op (disabled tracer / sampled-out iteration)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, **kv):
        pass

    def ctx(self):
        return None


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "args", "_t0",
                 "trace_id", "span_id", "parent_span_id")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any],
                 span_ctx: Optional["_prop.TraceContext"] = None,
                 parent_ctx: Optional["_prop.TraceContext"] = None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        if span_ctx is not None:
            self.trace_id, self.span_id = span_ctx.trace_id, span_ctx.span_id
            self.parent_span_id = (parent_ctx.span_id
                                   if parent_ctx is not None else None)
        elif parent_ctx is not None:
            self.trace_id = parent_ctx.trace_id
            self.span_id = _prop.new_span_id()
            self.parent_span_id = parent_ctx.span_id
        else:
            # Plain local span: ids only if an enclosing span on this
            # thread is part of a trace (resolved at __enter__).
            self.trace_id = self.span_id = self.parent_span_id = None

    def set_attr(self, **kv) -> None:
        self.args.update(kv)

    def ctx(self) -> Optional["_prop.TraceContext"]:
        """This span's propagation context (None when it has no trace
        identity) — hand it to child threads / remote callees."""
        if self.trace_id is None:
            return None
        return _prop.TraceContext(self.trace_id, self.span_id)

    def __enter__(self) -> "_Span":
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        if self.trace_id is None and stack:
            encl = stack[-1]
            if encl.trace_id is not None:
                self.trace_id = encl.trace_id
                self.span_id = _prop.new_span_id()
                self.parent_span_id = encl.span_id
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        tracer = self._tracer
        stack = tracer._tls.stack
        stack.pop()
        if stack:
            self.args.setdefault("parent", stack[-1].name)
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        if self.trace_id is not None:
            self.args["trace_id"] = self.trace_id
            self.args["span_id"] = self.span_id
            if self.parent_span_id is not None:
                self.args["parent_span_id"] = self.parent_span_id
        tracer._record({
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self._t0 - tracer._epoch_ns) / 1000.0,  # µs
            "dur": dur_ns / 1000.0,
            "pid": tracer._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": self.args,
        })
        return False


class Tracer:
    """See module docstring."""

    def __init__(self, max_events: Optional[int] = None, enabled: bool = True):
        if max_events is None:
            max_events = int(os.environ.get("DL4J_TPU_TRACE_BUFFER", "16384"))
        self.enabled = bool(enabled)
        self._events: deque = deque(maxlen=max(16, int(max_events)))
        self._lock = threading.Lock()
        # Count of every event ever recorded (not just those still in the
        # ring): the cursor of an incremental export. The oldest ring
        # entry's sequence number is always `_seq - len(_events)`.
        self._seq = 0
        self._tls = threading.local()
        # The wall-clock instant of the perf_counter epoch: places this
        # process's (monotonic) span timestamps on a shared timeline.
        self._epoch_unix_us = time.time() * 1e6
        self._epoch_ns = time.perf_counter_ns()
        self._pid = os.getpid()

    # ------------------------------------------------------------------ api

    def span(self, name: str, cat: str = "dl4j",
             span_ctx: Optional["_prop.TraceContext"] = None,
             parent_ctx: Optional["_prop.TraceContext"] = None, **args):
        """Open a span. ``span_ctx`` fixes this span's (trace_id,
        span_id) identity — the ids already advertised to remote callees;
        ``parent_ctx`` parents it under a (possibly remote) context with
        a fresh span id. With neither, ids are inherited from the
        enclosing span on this thread, or omitted entirely."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, cat, args, span_ctx=span_ctx,
                     parent_ctx=parent_ctx)

    def complete(self, name: str, t0_ns: int, dur_ns: int,
                 cat: str = "dl4j",
                 span_ctx: Optional["_prop.TraceContext"] = None,
                 parent_ctx: Optional["_prop.TraceContext"] = None,
                 **args) -> None:
        """Record an already-elapsed span from explicit perf_counter_ns
        endpoints — for phases whose start lived on another thread (queue
        wait measured at batch build, device dispatch attributed to each
        coalesced request)."""
        if not self.enabled:
            return
        if span_ctx is not None:
            args["trace_id"] = span_ctx.trace_id
            args["span_id"] = span_ctx.span_id
            if parent_ctx is not None:
                args["parent_span_id"] = parent_ctx.span_id
        elif parent_ctx is not None:
            args["trace_id"] = parent_ctx.trace_id
            args["span_id"] = _prop.new_span_id()
            args["parent_span_id"] = parent_ctx.span_id
        self._record({
            "name": name, "cat": cat, "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1000.0,
            "dur": max(0, dur_ns) / 1000.0,
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args,
        })

    def trace(self, name: Optional[str] = None, cat: str = "dl4j"):
        """Decorator form: `@tracer.trace("checkpoint.write")`."""

        def wrap(fn):
            span_name = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.span(span_name, cat=cat):
                    return fn(*a, **kw)

            return inner

        return wrap

    def instant(self, name: str, cat: str = "dl4j", **args) -> None:
        """Point-in-time marker (ph "i"), e.g. a checkpoint COMMIT."""
        if not self.enabled:
            return
        self._record({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1000.0,
            "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args,
        })

    def _record(self, ev: dict) -> None:
        with self._lock:
            self._seq += 1
            self._events.append(ev)

    # --------------------------------------------------------------- export

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def export_chrome(self, since: Optional[int] = None) -> Dict[str, Any]:
        """The dict form of a Chrome trace file: json.dump it and open it
        in Perfetto. ``epochUnixUs`` and ``pid`` are merge keys for
        timelines of several processes (trace viewers ignore them).

        ``since`` is the incremental cursor: the ``seq`` of an earlier
        export gives only the events recorded after it. Events that aged
        out of the ring before that are gone (it is a ring)."""
        with self._lock:
            seq = self._seq
            events = list(self._events)
        if since is not None:
            oldest = seq - len(events)
            events = events[max(0, min(len(events), int(since) - oldest)):]
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "epochUnixUs": self._epoch_unix_us, "pid": self._pid,
                "seq": seq}

    def clear(self) -> None:
        # `_seq` keeps counting across clears so existing cursors stay
        # valid (they simply see an empty delta).
        with self._lock:
            self._events.clear()

    def resize(self, max_events: int) -> None:
        with self._lock:
            self._events = deque(self._events,
                                 maxlen=max(16, int(max_events)))
