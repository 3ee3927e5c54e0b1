"""Host-to-device staging (counterpart of
`deeplearning4j_tpu/datasets/staging.py`).

- `transfer_cast(item, dtype)` casts a batch's floating features and
  labels on the host to a policy's `transfer_dtype` before the engine
  copies them to its device, so the copy moves fewer bytes (f32 to bf16
  halves them). Masks and integer parts (ids, image bytes) are left alone,
  and so are tensors already on a device. numpy has no bfloat16, so a cast
  part comes back as a CPU tensor of the transfer dtype, which the engines
  take as they take an array.
- `stage_to_device(ds, device=)` and `stage_item(item, device)` copy every
  host part of a batch container (DataSet, MultiDataSet, Superbatch,
  MultiSuperbatch) to the device and keep the container's type. On the
  card a part goes through a pinned host buffer and an asynchronous copy
  on a side stream, and the item carries an event recorded after its
  copies; `ready(item)` makes the consumer's stream wait on that event
  (the engines call it as they take a batch), so no read overtakes a copy,
  and marks the parts as used on that stream for the caching allocator.
  On the CPU a part becomes a tensor, and nothing waits.
- `DeviceStager` stages a batch stream on a worker thread: the next batch
  crosses to the device while the current one trains. Its in-flight window
  is a byte budget (`staging_budget_bytes`: `DL4J_TPU_STAGE_BYTES`, else
  half the free device memory `torch.cuda.mem_get_info` reports less the
  net's measured transient (`observability.memory.measured_model_bytes`
  beyond its leaves, which are already out of the free memory), else 256
  MiB); one batch larger than the budget is still admitted when the window
  is empty. A worker's exception is raised to the consumer; `close()`
  stops the worker and drops what it staged. `maybe_stage` wraps an
  epoch's source in one where that buys something, `close_stager` closes
  it. `DL4J_TPU_STAGING=0` turns staging off, `DL4J_TPU_STAGE_DEPTH` sets
  the queue depth (2).

Observability (reference :54-84): `dl4j_staging_inflight_bytes` and
`dl4j_staging_depth` (the windows and queues of every live stager),
`dl4j_staging_wait_seconds` (a stager thread blocked on its base's next),
`dl4j_staging_bytes_total` and `dl4j_staging_put_seconds_total{mode}`
(copy-issue seconds on a stager thread, "overlapped", or on the caller's,
"synchronous"); a stager given an `engine` adds its bytes to that
engine's `dl4j_host_to_device_bytes_total` (the engines time their own
iterator-next waits, `dl4j_input_wait_seconds`). A stager also
keeps its own counts (`staged_bytes`, `put_seconds`,
`max_inflight_bytes`, `last_wait`).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

# Series resolved once at import.
_M_INFLIGHT = _obs.metrics.gauge(
    "dl4j_staging_inflight_bytes",
    "Bytes admitted to DeviceStager in-flight windows and not yet handed "
    "to a consumer (bounded by the staging byte budget)")
_M_DEPTH = _obs.metrics.gauge(
    "dl4j_staging_depth",
    "Batches currently staged ahead across DeviceStager queues")
_M_STAGE_WAIT = _obs.metrics.histogram(
    "dl4j_staging_wait_seconds",
    "Stager-thread seconds blocked waiting on the base iterator's next "
    "(producer-side stall, the dual of dl4j_input_wait_seconds)")
_M_STAGED_BYTES = _obs.metrics.counter(
    "dl4j_staging_bytes_total",
    "Host bytes shipped to device by background DeviceStager threads "
    "(the overlapped share of host->device traffic)")
_M_PUT_SECONDS = _obs.metrics.counter(
    "dl4j_staging_put_seconds_total",
    "Host seconds spent issuing device_put, split by whether the put ran "
    "on a DeviceStager thread (overlapped with compute) or on the caller "
    "thread (synchronous)",
    label_names=("mode",))
_M_PUT_OVERLAPPED = _M_PUT_SECONDS.labels(mode="overlapped")
_M_PUT_SYNC = _M_PUT_SECONDS.labels(mode="synchronous")
# The engines' family (registering again returns it).
_H2D_FAMILY = _obs.metrics.counter(
    "dl4j_host_to_device_bytes_total",
    "Host-resident bytes staged to device with training batches",
    label_names=("engine",))


# Copies issued from a stager thread overlap with compute; the rest are
# synchronous, on the caller's thread.
_TLS = threading.local()


def _put_seconds_child():
    return (_M_PUT_OVERLAPPED if getattr(_TLS, "overlapped", False)
            else _M_PUT_SYNC)

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "f16": torch.float16,
           "fp16": torch.float16}


def as_torch_dtype(dtype):
    """A transfer dtype given as a torch dtype or a name; None stays."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def _cast(a, dtype: torch.dtype):
    if isinstance(a, torch.Tensor):
        if a.device.type == "cpu" and a.is_floating_point() \
                and a.dtype != dtype:
            return a.to(dtype)
        return a
    if a is None:
        return a
    arr = np.asarray(a)
    if np.issubdtype(arr.dtype, np.floating):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t if t.dtype == dtype else t.to(dtype)
    return a


def transfer_cast(item, transfer_dtype):
    """`item` (a DataSet or a MultiDataSet) with its floating features and
    labels cast to `transfer_dtype` (a torch dtype, or None for no cast);
    anything else passes through."""
    transfer_dtype = as_torch_dtype(transfer_dtype)
    if transfer_dtype is None:
        return item
    if isinstance(item, MultiDataSet):
        return MultiDataSet(
            features=[_cast(f, transfer_dtype) for f in item.features],
            labels=[_cast(lab, transfer_dtype) for lab in item.labels],
            features_masks=item.features_masks,
            labels_masks=item.labels_masks)
    if isinstance(item, DataSet):
        return DataSet(_cast(item.features, transfer_dtype),
                       _cast(item.labels, transfer_dtype),
                       item.features_mask, item.labels_mask)
    return item



def nbytes(a) -> int:
    """Bytes of one array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _is_host(a) -> bool:
    return a is not None and not (isinstance(a, torch.Tensor)
                                  and a.device.type != "cpu")


_SIDE_STREAMS = {}
_side_lock = threading.Lock()


def _side_stream(dev: torch.device):
    with _side_lock:
        s = _SIDE_STREAMS.get(dev.index)
        if s is None:
            s = _SIDE_STREAMS[dev.index] = torch.cuda.Stream(device=dev)
        return s


def _to_device(a, dev: torch.device, stream):
    """One part on `dev`: a device tensor as it is; a host part as a
    tensor (on the card through a pinned buffer, copied on `stream`)."""
    if a is None or not _is_host(a):
        return a
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if dev.type == "cpu":
        return t
    with torch.cuda.stream(stream):
        return t.pin_memory().to(dev, non_blocking=True)


def _parts(item):
    """The container's part lists, as (name, list or single) pairs."""
    if isinstance(item, MultiDataSet) or hasattr(item, "features_masks"):
        return ("features", "labels", "features_masks", "labels_masks"), True
    return ("features", "labels", "features_mask", "labels_mask"), False


def stage_item(item, device="cuda"):
    """`item` (DataSet, MultiDataSet, Superbatch or MultiSuperbatch) with
    every host part on `device`, the container's type kept; device parts
    pass as they are (reference :233). On the card the copies run on a
    side stream and the new item carries their event (see `ready`)."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = _side_stream(dev) if dev.type == "cuda" else None
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(dev))
    names, lists = _parts(item)
    vals = []
    for name in names:
        v = getattr(item, name, None)
        if lists:
            v = None if v is None else [_to_device(a, dev, stream)
                                        for a in v]
        else:
            v = _to_device(v, dev, stream)
        vals.append(v)
    if isinstance(item, MultiDataSet):
        out = MultiDataSet(features=vals[0], labels=vals[1],
                           features_masks=vals[2], labels_masks=vals[3])
    elif isinstance(item, DataSet):
        out = DataSet(*vals)
    else:
        out = type(item)(*vals, k=getattr(item, "k", 1))
    if stream is not None:
        ev = torch.cuda.Event()
        ev.record(stream)
        out._staged = (ev, stream)
    _put_seconds_child().inc(time.perf_counter() - t0)
    return out


def stage_to_device(ds, transfer_dtype=None, device="cuda"):
    """One DataSet's arrays on `device`, cast to `transfer_dtype` first
    (reference :192)."""
    if transfer_dtype is not None:
        ds = transfer_cast(ds, transfer_dtype)
    return stage_item(ds, device)


def _leaves(item):
    names, lists = _parts(item)
    for name in names:
        v = getattr(item, name, None)
        for a in (v or []) if lists else [v]:
            if a is not None:
                yield a


def ready(item):
    """Make the current stream wait for `item`'s staging copies (and mark
    its parts as used on that stream, so the allocator does not hand their
    memory out while it reads them). Returns `item`; an item that was not
    staged on the card passes as it is."""
    staged = getattr(item, "_staged", None)
    if staged is None:
        return item
    ev, stream = staged
    cur = torch.cuda.current_stream(stream.device)
    cur.wait_event(ev)
    for a in _leaves(item):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            a.record_stream(cur)
    return item


def host_item_nbytes(item) -> int:
    """Bytes a container moves when staged: its host parts (reference
    :299; a device cache's replay costs 0)."""
    if isinstance(item, (list, tuple)):
        return sum(host_item_nbytes(i) for i in item)
    if not hasattr(item, "features"):
        return nbytes(item) if _is_host(item) else 0
    return sum(nbytes(a) for a in _leaves(item) if _is_host(a))


def drop_item(item) -> None:
    """Let go of a staged item's copies: its event, so nothing waits on it
    (the caching allocator takes the memory back when the last reference
    goes; PyTorch has no eager free of a tensor's memory)."""
    if hasattr(item, "_staged"):
        item._staged = None


_DEFAULT_BUDGET = 256 << 20
_MIN_BUDGET = 16 << 20


def staging_enabled() -> bool:
    """`DL4J_TPU_STAGING=0|false|off` turns staging off (reference
    :331)."""
    return (os.environ.get("DL4J_TPU_STAGING", "").strip().lower()
            not in ("0", "false", "off"))


def staging_depth() -> int:
    """The stager's queue depth, `DL4J_TPU_STAGE_DEPTH` (default 2)."""
    try:
        return max(1, int(os.environ.get("DL4J_TPU_STAGE_DEPTH", "2")))
    except ValueError:
        return 2


def staging_budget_bytes(net=None, device=None) -> int:
    """A stager's in-flight byte budget (reference :347):
    `DL4J_TPU_STAGE_BYTES`, else half the free memory of the card
    (`torch.cuda.mem_get_info`, of `net`'s device or `device`) less the
    net's measured transient, and at least 16 MiB, else 256 MiB."""
    env = os.environ.get("DL4J_TPU_STAGE_BYTES")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    dev = torch.device(getattr(net, "device", None) or device or "cpu")
    if dev.type == "cuda" and torch.cuda.is_available():
        free, _ = torch.cuda.mem_get_info(dev)
        if net is not None:
            from deeplearning4j_tpu_torch.observability import memory as _mem

            # The measured footprint's leaves are already allocated (out
            # of `free`); its transient is what a step will still take.
            measured = _mem.measured_model_bytes(net)
            if measured:
                free -= max(0, measured - _mem.leaf_bytes(net, "cuda"))
        if free > 0:
            return max(_MIN_BUDGET, int(free) // 2)
    return _DEFAULT_BUDGET


_END = object()


class DeviceStager:
    """A batch stream staged on a worker thread (reference :385): items of
    `base`, `transform`ed, cast to `transfer_dtype` and staged by
    `stage_fn` (default `stage_item` to `device`, the net's if given;
    `device_stage=False` only prefetches on the host), handed over in
    order through a queue of `depth`; the bytes in flight are admitted
    against `max_bytes` before each copy. A worker's exception is raised
    on the consumer's side. `close()` is idempotent. `engine` names the
    engine whose host->device bytes the staged bytes are."""

    stages_to_device = True

    def __init__(self, base: Iterable, *, stage_fn: Optional[Callable] = None,
                 transform: Optional[Callable] = None, transfer_dtype=None,
                 device_stage: bool = True, depth: Optional[int] = None,
                 max_bytes: Optional[int] = None, net=None, device=None,
                 engine: Optional[str] = None):
        self.base = base
        self.device = (getattr(net, "device", None) if device is None
                       else device) or "cuda"
        self._transform = transform
        self._transfer_dtype = transfer_dtype
        self._device_stage = bool(device_stage)
        self._stage_fn = stage_fn or (lambda item: stage_item(item,
                                                              self.device))
        self.depth = staging_depth() if depth is None else max(1, int(depth))
        if max_bytes is None and self._device_stage:
            max_bytes = staging_budget_bytes(net, self.device)
        self.max_bytes = max_bytes
        self._h2d = (_H2D_FAMILY.labels(engine=engine)
                     if engine and self._device_stage else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._can_admit = threading.Condition(threading.Lock())
        self._inflight = 0
        self.max_inflight_bytes = 0
        self.staged_bytes = 0
        self.put_seconds = 0.0
        self.last_wait = 0.0
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._closed = False
        self._done = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="dl4j-device-stager")
        self._thread.start()

    def _admit(self, nb: int) -> bool:
        with self._can_admit:
            while (self.max_bytes is not None and self._inflight > 0
                   and self._inflight + nb > self.max_bytes):
                if self._stop.is_set():
                    return False
                self._can_admit.wait(timeout=0.1)
            if self._stop.is_set():
                return False
            self._inflight += nb
            self.max_inflight_bytes = max(self.max_inflight_bytes,
                                          self._inflight)
        _M_INFLIGHT.inc(nb)
        return True

    def _retire(self, nb: int, item=None, drop: bool = False) -> None:
        with self._can_admit:
            self._inflight -= nb
            self._can_admit.notify_all()
        _M_INFLIGHT.inc(-nb)
        if drop and item is not None:
            drop_item(item)

    def _offer(self, payload) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(payload, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        _TLS.overlapped = True
        try:
            base_it = iter(self.base)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(base_it)
                except StopIteration:
                    break
                _M_STAGE_WAIT.observe(time.perf_counter() - t0)
                if self._transform is not None:
                    item = self._transform(item)
                if self._transfer_dtype is not None:
                    item = transfer_cast(item, self._transfer_dtype)
                nb = host_item_nbytes(item) if self._device_stage else 0
                if self._device_stage:
                    if not self._admit(nb):
                        return
                    t0 = time.perf_counter()
                    try:
                        staged = self._stage_fn(item)
                    except BaseException:
                        self._retire(nb)
                        raise
                    self.put_seconds += time.perf_counter() - t0
                    self.staged_bytes += nb
                    _M_STAGED_BYTES.inc(nb)
                    if self._h2d is not None:
                        self._h2d.inc(nb)
                else:
                    staged = item
                if not self._offer((staged, nb)):
                    self._retire(nb, staged, drop=self._device_stage)
                    return
                _M_DEPTH.inc(1)
        except BaseException as e:  # raised on the consumer's side
            self._error = e
        finally:
            self._offer(_END)
            _TLS.overlapped = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done or self._closed:
            self._finish()
        t0 = time.perf_counter()
        payload = self._q.get()
        self.last_wait = time.perf_counter() - t0
        if payload is _END:
            self._done = True
            self._thread.join(timeout=5)
            self._finish()
        item, nb = payload
        _M_DEPTH.inc(-1)
        self._retire(nb)
        return item

    def _finish(self):
        if self._error is not None:
            raise self._error
        raise StopIteration

    def close(self) -> None:
        """Stop the worker, join it and drop what it staged and nobody
        took; the stager then iterates as exhausted (a stored worker error
        still raises)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        with self._can_admit:
            self._can_admit.notify_all()
        self._drain()
        self._thread.join(timeout=5)
        self._drain()

    def _drain(self) -> None:
        while True:
            try:
                payload = self._q.get_nowait()
            except queue.Empty:
                return
            if payload is _END:
                continue
            item, nb = payload
            _M_DEPTH.inc(-1)
            self._retire(nb, item, drop=self._device_stage)

    def __del__(self):  # pragma: no cover - a safety net at collection
        try:
            self.close()
        except Exception:
            pass


def maybe_stage(src, *, net=None, transfer_dtype=None,
                depth: Optional[int] = None, device=None,
                engine: Optional[str] = None):
    """`src` wrapped in a `DeviceStager` (reference :574), unless staging
    is off, `src` stages itself (`stages_to_device`), or it is a list or
    tuple of at most one batch."""
    if not staging_enabled():
        return src
    if getattr(src, "stages_to_device", False):
        return src
    if isinstance(src, (list, tuple)) and len(src) <= 1:
        return src
    return DeviceStager(src, net=net, device=device,
                        transfer_dtype=transfer_dtype, depth=depth,
                        engine=engine)


def close_stager(src) -> None:
    """Close `src` if it is a `DeviceStager` (reference :593)."""
    if isinstance(src, DeviceStager):
        src.close()
