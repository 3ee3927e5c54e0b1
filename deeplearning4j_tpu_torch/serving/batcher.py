"""Shape-bucket request batching for the predict path (counterpart of
`deeplearning4j_tpu/serving/batcher.py:43-387`).

A coalesced batch pads to the smallest bucket of a ladder (powers of two
up to `max_batch_size` by default), so the card sees a handful of batch
shapes. `warm()` runs one forward per bucket on zeros of the served shape
before traffic, which makes each kernel's per-shape setup and cuDNN's
plans for every shape the batcher will dispatch.

Admission is bounded: the queue has a hard depth and `submit` raises
`ServerOverloadedError` (503 + `Retry-After`) rather than buffer without
bound. Every `_Pending` carries a deadline and a `cancelled` flag, so a
request whose caller gave up is dropped when the batch is built and never
reaches the device (counted as `dl4j_requests_total{outcome="timeout"}`).
A batch that fails sets the error on each of its callers; nothing retries
it on another path.

Input dtype policy: the expected feature dtype comes from the model's
declared structure (the wire policy of `nn/conf/preprocessors.py`, the
engines' `_uint8_policy` / `_uint8_policies`). Ids models get int32
features and a 400 on fractional floats; value models get float32.

Still to come: the tracer spans, ledger records and crash bundles of the
batch loop (ROADMAP A.14), and grouping by LoRA adapter (A.12).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import preprocessors as _pre
from deeplearning4j_tpu_torch.serving import metrics as _m
from deeplearning4j_tpu_torch.serving.errors import (
    InputValidationError,
    ServerOverloadedError,
)


def bucket_ladder(max_batch_size: int,
                  buckets: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
    """The padded batch-size ladder: explicit `buckets` (capped at and
    extended to `max_batch_size`), or powers of two up to it."""
    if buckets:
        ladder = sorted({int(b) for b in buckets if 0 < int(b)})
        if not ladder:
            raise ValueError("batch_buckets must contain a positive size")
        return tuple(b for b in ladder if b < max_batch_size) + (
            int(max_batch_size),)
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(int(max_batch_size))
    return tuple(out)


# ------------------------------------------------------------ input dtype


def expected_input_kind(net) -> str:
    """'ids' when the model's single input feeds an ids-format
    EmbeddingLayer (the `nn/conf/preprocessors.py` policy), else
    'values'."""
    policy = getattr(net, "_uint8_policy", None)
    if policy is None:
        policies = getattr(net, "_uint8_policies", None)
        if policies and len(policies) == 1:
            policy = next(iter(policies.values()))
    return "ids" if policy == _pre.UINT8_IDS else "values"


def canonicalize_features(net, data) -> np.ndarray:
    """One request's features, staged for batching, or
    `InputValidationError` (400). Ids models keep integer precision
    (int32, never through float) and a 2-D token grid gains the trailing
    index axis the ids EmbeddingLayer reads."""
    try:
        arr = np.asarray(data)
    except Exception as e:
        raise InputValidationError(f"features are not array-like: {e}")
    if arr.dtype.kind not in "fiub":
        raise InputValidationError(
            f"features must be numeric, got dtype {arr.dtype}")
    if arr.ndim == 0:
        raise InputValidationError("features must be a batch of examples")
    if expected_input_kind(net) == "ids":
        if arr.dtype.kind == "f":
            if not np.all(np.isfinite(arr)) or np.any(np.mod(arr, 1) != 0):
                raise InputValidationError(
                    "this model consumes integer token ids; got fractional "
                    "or non-finite floats")
        arr = arr.astype(np.int32)
        if arr.ndim == 2:
            arr = arr[..., None]  # [b, t] -> [b, t, 1] index layout
        return arr
    return np.ascontiguousarray(arr, np.float32)


def infer_feature_shape(net) -> Optional[Tuple[int, ...]]:
    """Per-example feature shape from the model's declared input type, or
    from the first layer's `n_in`; None when the model declares neither
    (a copy of the reference's `compilation/warmup.py:36-65`)."""
    conf = getattr(net, "conf", None)
    itypes: List[Any] = []
    if conf is not None:
        single = getattr(conf, "input_type", None)
        if single is not None:
            itypes = [single]
        else:
            named = getattr(conf, "input_types", None) or {}
            inputs = getattr(conf, "network_inputs", list(named))
            if named and len(inputs) == 1 and inputs[0] in named:
                itypes = [named[inputs[0]]]
    if itypes:
        t = itypes[0]
        if t.kind == "cnn":
            return (t.height, t.width, t.channels)
        if t.kind in ("ff", "cnnflat"):
            return (t.flat_size(),)
        if t.kind == "rnn":
            return (t.timeseries_length or 8, t.size)
    layers = getattr(net, "layers", None)
    if layers:
        n_in = getattr(layers[0], "n_in", None)
        if n_in:
            return (int(n_in),)
    return None


def serving_feature_spec(net, warmup_shape=None):
    """(per-example shape, dtype) the batcher pads and warms with. An
    explicit `warmup_shape` is trusted; otherwise the declared input type
    decides, an ids model reading the [t, 1] index layout in int32."""
    kind = expected_input_kind(net)
    dtype = np.int32 if kind == "ids" else np.float32
    if warmup_shape is not None:
        return tuple(warmup_shape), dtype
    shape = infer_feature_shape(net)
    if shape is not None and kind == "ids" and len(shape) == 2:
        shape = (shape[0], 1)
    return shape, dtype


# ---------------------------------------------------------------- batcher


class _Pending:
    __slots__ = ("array", "event", "result", "error", "deadline",
                 "cancelled")

    def __init__(self, array: np.ndarray, deadline: Optional[float] = None):
        self.array = array
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.deadline = deadline          # time.monotonic() instant or None
        self.cancelled = False            # set by an abandoning caller


class ShapeBucketBatcher:
    """One model's predict-path batcher: bounded admission queue,
    delay-window coalescing, bucket-padded dispatch. `start()` spawns the
    loop thread, `submit()` enqueues (or sheds), `stop()` ends it.

    `stats` counts what the loop dispatched (`batches`, real `rows`,
    `padded_rows`, and `dropped` requests); the loop thread alone writes
    it."""

    def __init__(self, net, model_name: str = "default",
                 max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 max_delay_s: float = 0.005,
                 queue_depth: int = 256,
                 warmup_shape=None):
        self.net = net
        self.model_name = model_name
        self.buckets = bucket_ladder(max_batch_size, buckets)
        self.max_batch_size = self.buckets[-1]
        self.max_delay_s = float(max_delay_s)
        self.warmup_shape = warmup_shape
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=int(queue_depth))
        self._thread: Optional[threading.Thread] = None
        self.stats = {"batches": 0, "rows": 0, "padded_rows": 0,
                      "dropped": 0}
        _m.MODEL_QUEUE_DEPTH.labels(
            model=model_name, route="predict").set_function(self._queue.qsize)

    # ------------------------------------------------------------ control

    def start(self) -> "ShapeBucketBatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._batch_loop,
                name=f"dl4j-batcher-{self.model_name}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is not None:
            self._thread = None
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass  # the loop ends at the sentinel after the backlog
            t.join(timeout=10.0)

    def qsize(self) -> int:
        return self._queue.qsize()

    # ---------------------------------------------------------- admission

    def submit(self, arr: np.ndarray,
               deadline: Optional[float] = None) -> _Pending:
        """Enqueue one request's rows; sheds (503 + Retry-After) when the
        bounded queue is full."""
        p = _Pending(arr, deadline)
        try:
            self._queue.put_nowait(p)
        except queue.Full:
            raise ServerOverloadedError(
                f"model {self.model_name!r} admission queue is full "
                f"({self._queue.maxsize} requests); retry later")
        return p

    # ------------------------------------------------------------- warmup

    def warm(self) -> None:
        """One forward per bucket on zeros of the served shape (the
        reference's path for an engine without a compile step)."""
        shape, dtype = serving_feature_spec(self.net, self.warmup_shape)
        if shape is None:
            raise ValueError(
                "cannot infer the model's input shape; pass "
                "warmup_shape=(...) to InferenceServer")
        for b in self.buckets:
            self._forward(np.zeros((b,) + tuple(shape), dtype))

    # ------------------------------------------------------------ batching

    def _forward(self, x: np.ndarray) -> np.ndarray:
        out = self.net.output(x)
        if isinstance(out, list):  # ComputationGraph returns [out, ...]
            out = out[0]
        return np.asarray(out)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run_batch(self, pending: List[_Pending]) -> None:
        now = time.monotonic()
        live: List[_Pending] = []
        for p in pending:
            expired = p.deadline is not None and now > p.deadline
            if p.cancelled or expired:
                # Dropped before the device sees it.
                _m.REQUESTS.labels(model=self.model_name, route="predict",
                                   outcome="timeout").inc()
                self.stats["dropped"] += 1
                if expired and not p.cancelled:
                    p.error = "__deadline__"
                p.event.set()
                continue
            live.append(p)
        # Requests of different per-example shapes cannot share one padded
        # batch: one sub-batch per shape.
        groups: dict = {}
        for p in live:
            groups.setdefault(p.array.shape[1:], []).append(p)
        for group in groups.values():
            self._run_group(group)

    def _run_group(self, live: List[_Pending]) -> None:
        counts = [p.array.shape[0] for p in live]
        try:
            x = np.concatenate([p.array for p in live], axis=0)
            n = x.shape[0]
            _m.BATCH_SIZE.observe(n)
            bucket = self._bucket_for(n)
            if n < bucket:
                pad = np.zeros((bucket - n,) + x.shape[1:], x.dtype)
                x = np.concatenate([x, pad], axis=0)
            preds = self._forward(x)[:n]
            self.stats["batches"] += 1
            self.stats["rows"] += n
            self.stats["padded_rows"] += bucket
            off = 0
            for p, c in zip(live, counts):
                p.result = preds[off:off + c]
                off += c
        except Exception as e:  # every caller gets the failure; the loop
            for p in live:      # thread survives a bad batch
                p.error = f"{type(e).__name__}: {e}"
        for p in live:
            p.event.set()

    def _batch_loop(self) -> None:
        # inference_mode is per thread: the loop's forwards run under it.
        with torch.inference_mode():
            self._batch_loop_inner()

    def _batch_loop_inner(self) -> None:
        holdover: Optional[_Pending] = None
        while True:
            first = holdover if holdover is not None else self._queue.get()
            holdover = None
            if first is None:
                return
            batch = [first]
            total = first.array.shape[0]
            # Coalesce what arrives within the delay window, up to the
            # largest bucket; a request that would overflow it waits for
            # the next batch.
            end = time.monotonic() + self.max_delay_s
            while total < self.max_batch_size:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    self._run_batch(batch)
                    return
                if total + item.array.shape[0] > self.max_batch_size:
                    holdover = item
                    break
                batch.append(item)
                total += item.array.shape[0]
            self._run_batch(batch)
