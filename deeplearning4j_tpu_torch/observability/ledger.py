"""Request ledger: one record per serving request (counterpart of
`deeplearning4j_tpu/observability/ledger.py:53-357`, with a plain
`threading.Lock` where the reference takes a traced lock).

Histograms answer how slow a route was and spans what happened inside a
request; the ledger answers which tenant spent the device-seconds. Every
request through the serving tier (the batcher's predict path, the
scheduler's generate path) opens one record carrying

- identity: trace id, model, tenant (adapter), route;
- lifecycle marks: admission -> queue done -> prefill or prefix hit ->
  first token -> completion, seconds from the open;
- volume: tokens in and out, speculative accepts and rejects, the KV
  pages copied on write;
- **attributed device-seconds**: each batched dispatch's wall time split
  across the requests it served, at the two dispatch points
  (`serving/batcher.py` by row share, `serving/scheduler.py` a decode
  round evenly across its active slots), so the tenants' sums add up to
  the measured dispatch time (`dl4j_serving_dispatch_seconds_total`).

Closed records land in a bounded ring (the flight recorder writes it into
every bundle as ``ledger.jsonl``), feed the per-tenant rows
(``GET /v1/tenants``, the ``dl4j_tenant_*`` counters), and may be spooled
to a JSONL file. An open is one object and one clock read; updates are
attribute writes; only a close takes the ledger's lock.

Env knobs (read once at import; constructor arguments override them):

- ``DL4J_TPU_LEDGER``        "0" / "false" / "off" disables recording
  (open() returns a shared no-op record; close() ignores it)
- ``DL4J_TPU_LEDGER_RING``   closed-record ring capacity (default 4096)
- ``DL4J_TPU_LEDGER_SPOOL``  JSONL spool path; empty (default): ring only,
  no file I/O on the serving path
- ``DL4J_TPU_LEDGER_SAMPLE`` share of closed records spooled (default
  1.0; 0.01 spools every 100th record, deterministically)
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional



def _env_flag(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).lower() not in ("0", "false", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class RequestRecord:
    """One in-flight request's ledger entry. Field updates are plain
    attribute ops on purpose — each phase of a request has a single
    writer thread (HTTP handler, then batcher/scheduler loop, then the
    handler again after the completion event), so no per-record lock."""

    __slots__ = ("trace_id", "route", "model", "adapter", "t_wall",
                 "_t0_ns", "marks", "tokens_in", "tokens_out",
                 "spec_accepted", "spec_rejected", "cow_page_copies",
                 "device_seconds", "queue_wait_s", "prefix_hit", "outcome",
                 "duration_s", "_dev_child")

    def __init__(self, route: str, model: str, adapter: str,
                 trace_id: Optional[str], tokens_in: int, dev_child):
        self.trace_id = trace_id
        self.route = route
        self.model = model
        self.adapter = adapter
        self.t_wall = time.time()
        self._t0_ns = time.perf_counter_ns()
        self.marks: Dict[str, float] = {}
        self.tokens_in = int(tokens_in)
        self.tokens_out = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.cow_page_copies = 0
        self.device_seconds = 0.0
        self.queue_wait_s = 0.0
        self.prefix_hit: Optional[bool] = None
        self.outcome: Optional[str] = None
        self.duration_s = 0.0
        self._dev_child = dev_child

    def mark(self, name: str) -> None:
        """Lifecycle timestamp, seconds relative to open (admitted,
        queue_done, prefill, prefix_hit, first_token, done, ...)."""
        self.marks[name] = (time.perf_counter_ns() - self._t0_ns) / 1e9

    def add_device_seconds(self, s: float) -> None:
        """This request's share of one batched dispatch's wall time."""
        self.device_seconds += s
        dev = self._dev_child
        if dev is not None:
            dev.inc(s)

    def add_tokens_in(self, n: int) -> None:
        self.tokens_in += n

    def add_tokens_out(self, n: int = 1) -> None:
        self.tokens_out += n

    def add_speculative(self, accepted: int = 0, rejected: int = 0) -> None:
        self.spec_accepted += accepted
        self.spec_rejected += rejected

    def add_cow_copies(self, n: int) -> None:
        self.cow_page_copies += n

    def set_queue_wait(self, s: float) -> None:
        self.queue_wait_s = s

    def set_prefix_hit(self, hit: bool) -> None:
        self.prefix_hit = bool(hit)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "route": self.route,
            "model": self.model,
            "adapter": self.adapter,
            "t_wall": self.t_wall,
            "marks": {k: round(v, 6) for k, v in self.marks.items()},
            "tokens_in": self.tokens_in,
            "tokens_out": self.tokens_out,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "cow_page_copies": self.cow_page_copies,
            "device_seconds": round(self.device_seconds, 9),
            "queue_wait_s": round(self.queue_wait_s, 6),
            "prefix_hit": self.prefix_hit,
            "outcome": self.outcome,
            "duration_s": round(self.duration_s, 6),
        }


class _NoopRecord:
    """Shared do-nothing record: disabled ledgers hand this out so call
    sites never branch (mirrors the tracer's NOOP_SPAN)."""

    __slots__ = ()

    def mark(self, name: str) -> None:
        pass

    def add_device_seconds(self, s: float) -> None:
        pass

    def add_tokens_in(self, n: int) -> None:
        pass

    def add_tokens_out(self, n: int = 1) -> None:
        pass

    def add_speculative(self, accepted: int = 0, rejected: int = 0) -> None:
        pass

    def add_cow_copies(self, n: int) -> None:
        pass

    def set_queue_wait(self, s: float) -> None:
        pass

    def set_prefix_hit(self, hit: bool) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {}


NOOP_RECORD = _NoopRecord()


class RequestLedger:
    """See module docstring. One instance (`observability.ledger.ledger`,
    re-exported as `observability.request_ledger`) is the process-global
    default; tests build their own."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None,
                 spool_path: Optional[str] = None,
                 sample: Optional[float] = None):
        self.enabled = (_env_flag("DL4J_TPU_LEDGER")
                        if enabled is None else bool(enabled))
        if capacity is None:
            capacity = _env_int("DL4J_TPU_LEDGER_RING", 4096)
        self.spool_path = (os.environ.get("DL4J_TPU_LEDGER_SPOOL", "")
                           if spool_path is None else spool_path) or None
        if sample is None:
            sample = _env_float("DL4J_TPU_LEDGER_SAMPLE", 1.0)
        # fraction -> deterministic every-Nth stride (0 disables the spool)
        self._spool_every = (0 if sample <= 0.0
                             else max(1, int(round(1.0 / min(1.0, sample)))))
        self._ring: deque = deque(maxlen=max(16, int(capacity)))
        self._lock = threading.Lock()
        self._closed = 0
        self._spool_file = None
        self._tenants: Dict[tuple, Dict[str, Any]] = {}
        self._dev_family = None
        self._tok_family = None

    # ------------------------------------------------------------ families

    def _families(self):
        """The tenant counters, resolved lazily from the process-global
        registry (`serving/metrics.py` registers the same families; the
        registry keeps one family a name)."""
        if self._dev_family is None:
            from deeplearning4j_tpu_torch import observability as _obs

            self._dev_family = _obs.metrics.counter(
                "dl4j_tenant_device_seconds_total",
                "Attributed device-seconds per tenant",
                label_names=("model", "adapter"))
            self._tok_family = _obs.metrics.counter(
                "dl4j_tenant_tokens_total",
                "Tokens in/out per tenant",
                label_names=("model", "adapter", "direction"))
        return self._dev_family, self._tok_family

    # ----------------------------------------------------------- lifecycle

    def open(self, route: str, model: str, adapter: str = "",
             trace_id: Optional[str] = None, tokens_in: int = 0):
        """Start a record at admission. Returns NOOP_RECORD when the
        ledger is disabled so call sites stay branch-free."""
        if not self.enabled:
            return NOOP_RECORD
        try:
            if trace_id is None:
                from deeplearning4j_tpu_torch.observability import propagate

                ctx = propagate.current()
                trace_id = ctx.trace_id if ctx is not None else None
            dev, _ = self._families()
            child = dev.labels(model=str(model), adapter=str(adapter))
            return RequestRecord(route, str(model), str(adapter), trace_id,
                                 tokens_in, child)
        except Exception:
            return NOOP_RECORD

    def close(self, rec, outcome: str = "ok") -> None:
        """Finalize a record: outcome + duration, ring append, tenant
        aggregate update, token counters, optional JSONL spool. Never
        raises (accounting must not take down serving)."""
        if rec is None or rec is NOOP_RECORD or not self.enabled:
            return
        try:
            rec.outcome = str(outcome)
            rec.duration_s = (time.perf_counter_ns() - rec._t0_ns) / 1e9
            doc = rec.to_dict()
            _, tok = self._families()
            if rec.tokens_in:
                tok.labels(model=rec.model, adapter=rec.adapter,
                           direction="in").inc(rec.tokens_in)
            if rec.tokens_out:
                tok.labels(model=rec.model, adapter=rec.adapter,
                           direction="out").inc(rec.tokens_out)
            with self._lock:
                self._closed += 1
                self._ring.append(doc)
                agg = self._tenants.setdefault(
                    (rec.model, rec.adapter), {
                        "requests": 0, "tokens_in": 0, "tokens_out": 0,
                        "device_seconds": 0.0, "queue_wait_s": 0.0,
                        "outcomes": {}})
                agg["requests"] += 1
                agg["tokens_in"] += rec.tokens_in
                agg["tokens_out"] += rec.tokens_out
                agg["device_seconds"] += rec.device_seconds
                agg["queue_wait_s"] += rec.queue_wait_s
                agg["outcomes"][rec.outcome] = (
                    agg["outcomes"].get(rec.outcome, 0) + 1)
                spool = (self._spool_every
                         and self._closed % self._spool_every == 0)
                if spool:
                    self._spool(doc)
        except Exception:
            pass

    def _spool(self, doc: Dict[str, Any]) -> None:
        """Append one JSONL line; the handle opens lazily and stays open
        (called under the ledger lock)."""
        if not self.spool_path:
            return
        try:
            if self._spool_file is None:
                d = os.path.dirname(self.spool_path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._spool_file = open(self.spool_path, "a")
            self._spool_file.write(json.dumps(doc, default=str) + "\n")
            self._spool_file.flush()
        except Exception:
            self._spool_file = None

    # ------------------------------------------------------------ plumbing

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Closed records, oldest first (the flight recorder writes this
        as ledger.jsonl into every bundle)."""
        with self._lock:
            records = list(self._ring)
        if limit is not None:
            records = records[-int(limit):]
        return records

    def tenants(self) -> List[Dict[str, Any]]:
        """Per-(model, adapter) accounting rows for `GET /v1/tenants`."""
        with self._lock:
            items = [(k, dict(v, outcomes=dict(v["outcomes"])))
                     for k, v in self._tenants.items()]
        rows = []
        for (model, adapter), agg in sorted(items):
            row = {"model": model, "adapter": adapter}
            row.update(agg)
            n = agg["requests"]
            row["queue_wait_mean_s"] = (agg["queue_wait_s"] / n) if n else 0.0
            rows.append(row)
        return rows

    def status(self) -> Dict[str, Any]:
        with self._lock:
            n, closed = len(self._ring), self._closed
        return {"enabled": self.enabled, "capacity": self._ring.maxlen,
                "records": n, "closed_total": closed,
                "spool_path": self.spool_path,
                "spool_every": self._spool_every}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._tenants.clear()
            self._closed = 0


# The process-global ledger; `observability.request_ledger` re-exports it.
ledger = RequestLedger()
