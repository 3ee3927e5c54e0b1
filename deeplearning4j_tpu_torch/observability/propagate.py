"""Cross-process trace-context propagation, the ``X-DL4J-Trace`` header
(counterpart of `deeplearning4j_tpu/observability/propagate.py`; the header
is the same byte for byte, so each package parses the other's).

A W3C-traceparent-style context (``trace_id`` / ``span_id``) rides every
hop of one request:

- over HTTP as the ``X-DL4J-Trace`` header, read by `serving/http.py`
  (the `replica.<route>` span is its child);
- across threads inside one process on the queue items (`_Pending`,
  `GenerationRequest`): the tracer's thread-local stack does not cross to
  the batcher or the decode loop, so the context travels with the item.

Header format (W3C traceparent with our header name)::

    X-DL4J-Trace: 00-<32 hex trace_id>-<16 hex span_id>-01

`tracing.Tracer.span(..., span_ctx=..., parent_ctx=...)` consumes these
contexts: its events carry ``trace_id`` / ``span_id`` / ``parent_span_id``
in their args. The inbound HTTP handler installs the thread's current
context (`bound`); queue admissions read it (`current`), outbound calls
forward it (`trace_headers`). Minting a context is one `os.urandom` call.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

# The propagation header (HTTP) and RPC-document field (coordinator).
TRACE_HEADER = "X-DL4J-Trace"
TRACE_FIELD = "trace"

_HEADER_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


class TraceContext:
    """One (trace_id, span_id) pair: the identity of a span as seen by
    its remote children. Immutable by convention."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    def child(self) -> "TraceContext":
        """Same trace, fresh span id — the identity of a new child span."""
        return TraceContext(self.trace_id, new_span_id())

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def mint() -> TraceContext:
    """A brand-new trace root (one per request at the edge)."""
    return TraceContext(new_trace_id(), new_span_id())


def parse(header: Optional[str]) -> Optional[TraceContext]:
    """Parse an ``X-DL4J-Trace`` value; None for absent/malformed input
    (an unparseable header must never fail the request it rode in on)."""
    if not header:
        return None
    m = _HEADER_RE.match(str(header).strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if set(trace_id) == {"0"} or set(span_id) == {"0"}:
        return None  # all-zero ids are invalid per the W3C grammar
    return TraceContext(trace_id, span_id)


# ------------------------------------------------------ current context

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context bound to this thread (None outside a traced request)."""
    return getattr(_tls, "ctx", None)


class bound:
    """``with bound(ctx): ...`` — install `ctx` as this thread's current
    context for the block (restores the previous one on exit; `ctx` may
    be None, which clears the binding for the block)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        self._prev = current()
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc) -> bool:
        _tls.ctx = self._prev
        return False


def trace_headers(extra: Optional[Dict[str, str]] = None,
                  ctx: Optional[TraceContext] = None) -> Dict[str, str]:
    """HTTP headers forwarding the given (or thread-current) trace
    context: the one helper an outbound request routes through."""
    out = dict(extra or {})
    ctx = ctx if ctx is not None else current()
    if ctx is not None:
        out[TRACE_HEADER] = ctx.to_header()
    return out
