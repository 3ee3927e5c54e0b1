"""Dataset iterators (counterpart of `deeplearning4j_tpu/datasets/
iterators.py`): `maybe_reset`, `fast_forward`, the `DataSetIterator`
protocol, `ListDataSetIterator`, `AsyncDataSetIterator` (background
prefetch, to the device by default, through `datasets/staging.py`'s
`DeviceStager`), `DeviceCacheDataSetIterator` (every batch staged to the
device once and replayed from there), `MultipleEpochsIterator`,
`SamplingDataSetIterator`, `ExistingDataSetIterator` and
`IteratorDataSetIterator`; and superstep training's blocks: `Superbatch`
and `MultiSuperbatch` (K same-signature batches stacked on a new leading
axis), `batch_signature`, `batch_nbytes`, `stack_superbatch` and
`SuperbatchIterator`, which the engines' superstep path consumes
(`nn/superstep.py`).

Batches are host numpy arrays or tensors; a staged batch holds tensors on
its device. The device is an argument (`device`, default the card, as the
engines'), or the net's where an iterator is given one.

Observability (reference :42-46): `dl4j_device_cache_bytes` (the bytes of
every `DeviceCacheDataSetIterator`'s cache, also its `cache_bytes`) and
`dl4j_input_wait_seconds{source="superstep"}` (a `SuperbatchIterator`
blocked on its base's next: with K batches a dispatch, the waits the
engine's own loop can no longer see).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch.datasets import staging as _staging
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.staging import (
    DeviceStager,
    drop_item,
    stage_item,
    stage_to_device,
    transfer_cast,
)

_log = logging.getLogger(__name__)

_M_CACHE_BYTES = _obs.metrics.gauge(
    "dl4j_device_cache_bytes",
    "Bytes of training batches resident in HBM across "
    "DeviceCacheDataSetIterator caches")
_M_INPUT_WAIT = _obs.metrics.histogram(
    "dl4j_input_wait_seconds",
    "Host seconds blocked in iterator-next waiting for the next batch "
    "(input starvation; the device is idle while this accrues)",
    label_names=("source",)).labels(source="superstep")


def maybe_reset(iterator) -> bool:
    """Reset `iterator` if it can be; returns whether `reset()` ran. Only
    "cannot be reset" (no `reset`, or NotImplementedError) passes quietly;
    any other failure is logged, since a half-run reset can leave the next
    epoch a partial stream."""
    reset = getattr(iterator, "reset", None)
    if reset is None:
        return False
    try:
        reset()
        return True
    except NotImplementedError:
        return False
    except Exception:
        _log.warning("%s.reset() failed unexpectedly; continuing without "
                     "reset", type(iterator).__name__, exc_info=True)
        return False


def fast_forward(iterator, n: int):
    """Reset `iterator` where it can be and skip its first `n` batches;
    returns an iterator at batch `n` (reference :75): a run resumed from a
    checkpoint at step n sees the batches the uninterrupted run saw. The
    skipped batches are drawn and dropped; a shorter stream leaves an
    exhausted iterator."""
    maybe_reset(iterator)
    it = iter(iterator)
    for _ in range(max(0, int(n))):
        try:
            next(it)
        except StopIteration:
            break
    return it


class DataSetIterator:
    """Iterator protocol (ND4J `DataSetIterator`)."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> Optional[int]:
        return None

    def total_examples(self) -> Optional[int]:
        return None


class ListDataSetIterator(DataSetIterator):
    """Minibatches of one DataSet (or a list of DataSets as they are).
    With `shuffle`, each pass draws a new permutation from a
    `RandomState(seed)` made once: of the examples for one DataSet, of the
    batch order for a list."""

    def __init__(self, data, batch_size: int = 32, shuffle: bool = False,
                 seed: Optional[int] = None):
        if isinstance(data, DataSet):
            self._batches = data.batch_by(batch_size)
            self._source = data
        else:
            self._batches = list(data)
            self._source = None
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        src = self._source
        if self._shuffle and src is not None:
            idx = self._rng.permutation(src.num_examples())

            def take(a):
                return None if a is None else a[idx]

            return iter(DataSet(take(src.features), take(src.labels),
                                take(src.features_mask),
                                take(src.labels_mask)
                                ).batch_by(self._batch_size))
        if self._shuffle:
            order = self._rng.permutation(len(self._batches))
            return iter([self._batches[i] for i in order])
        return iter(self._batches)

    def batch_size(self):
        return self._batch_size

    def total_examples(self):
        return sum(b.num_examples() for b in self._batches)


class AsyncDataSetIterator(DataSetIterator):
    """Background prefetch (reference :155): a `DeviceStager` worker thread
    pulls from `base`, casts to `transfer_dtype` and, with
    `device_prefetch` (default), stages each batch to `device` while the
    consumer computes; without it, the batches are prefetched on the host.
    An exception in the worker is raised to the consumer. One worker per
    iterator: iterating again, or `reset`, closes the live one first."""

    def __init__(self, base: Iterable, queue_size: int = 4,
                 device_prefetch: bool = True, transfer_dtype=None,
                 device="cuda"):
        self.base = base
        self.queue_size = max(1, int(queue_size))
        self.device_prefetch = device_prefetch
        self.transfer_dtype = transfer_dtype
        self.device = device
        self._active: Optional[DeviceStager] = None

    @property
    def stages_to_device(self) -> bool:
        return bool(self.device_prefetch)

    def __iter__(self):
        if self._active is not None:
            self._active.close()
        self._active = DeviceStager(
            self.base, depth=self.queue_size,
            transfer_dtype=self.transfer_dtype,
            device_stage=self.device_prefetch, device=self.device)
        return self._active

    def reset(self):
        stager, self._active = self._active, None
        if stager is not None:
            stager.close()
        if hasattr(self.base, "reset"):
            self.base.reset()


def _ds_bytes(ds) -> int:
    return sum(_staging.nbytes(a) for a in (
        ds.features, ds.labels, ds.features_mask, ds.labels_mask)
        if a is not None)


class DeviceCacheDataSetIterator(DataSetIterator):
    """Every batch of `base` staged to `device` once, then replayed from
    device memory every epoch (reference :208). `max_bytes` caps the cache:
    past it a MemoryError, and the batches staged so far are dropped."""

    stages_to_device = True

    def __init__(self, base: Iterable, max_bytes: Optional[int] = None,
                 transfer_dtype=None, device="cuda"):
        self.base = base
        self.max_bytes = max_bytes
        self.transfer_dtype = transfer_dtype
        self.device = device
        self._cache: Optional[List[DataSet]] = None
        self.cache_bytes = 0

    def __iter__(self):
        if self._cache is None:
            staged, total = [], 0
            try:
                for ds in self.base:
                    ds = transfer_cast(ds, self.transfer_dtype)
                    total += _ds_bytes(ds)
                    if self.max_bytes is not None and total > self.max_bytes:
                        raise MemoryError(
                            f"DeviceCacheDataSetIterator: dataset exceeds "
                            f"max_bytes={self.max_bytes}; use "
                            f"AsyncDataSetIterator for streaming-scale data")
                    staged.append(stage_to_device(ds, device=self.device))
            except BaseException:
                for item in staged:
                    drop_item(item)
                raise
            self._cache = staged
            self.cache_bytes = total
            _M_CACHE_BYTES.inc(total)
        return iter(self._cache)

    def reset(self):
        pass  # the cache replays; the base is read once

    def invalidate(self):
        """Drop the device cache (the data underneath changed)."""
        self._cache = None
        _M_CACHE_BYTES.inc(-self.cache_bytes)
        self.cache_bytes = 0

    def total_examples(self):
        if self._cache is not None:
            return sum(d.num_examples() for d in self._cache)
        return None


class MultipleEpochsIterator(DataSetIterator):
    """`base` replayed `num_epochs` times, reset before each (reference
    :279)."""

    def __init__(self, num_epochs: int, base: Iterable):
        self.num_epochs = int(num_epochs)
        self.base = base

    def __iter__(self):
        for _ in range(self.num_epochs):
            if hasattr(self.base, "reset"):
                self.base.reset()
            yield from self.base

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()


def _take(a, idx):
    return None if a is None else a[idx]


class SamplingDataSetIterator(DataSetIterator):
    """`total_batches` batches of `batch_size` rows drawn with replacement
    from `RandomState(seed)` (reference :297)."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: Optional[int] = None):
        self.data = data
        self._batch_size = batch_size
        self.total_batches = total_batches
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        d = self.data
        n = d.num_examples()
        for _ in range(self.total_batches):
            idx = self._rng.randint(0, n, self._batch_size)
            yield DataSet(d.features[idx], _take(d.labels, idx),
                          _take(d.features_mask, idx),
                          _take(d.labels_mask, idx))

    def batch_size(self):
        return self._batch_size


class ExistingDataSetIterator(DataSetIterator):
    """Any iterable of DataSets, read once into a list (reference :322)."""

    def __init__(self, iterable: Iterable):
        self._items = list(iterable)

    def __iter__(self):
        return iter(self._items)

    def total_examples(self):
        return sum(d.num_examples() for d in self._items)


class IteratorDataSetIterator(DataSetIterator):
    """A stream of DataSets re-cut into batches of `batch_size` rows; the
    rest comes as a last, shorter batch (reference :335)."""

    def __init__(self, base: Iterable, batch_size: int):
        self.base = base
        self._batch_size = batch_size

    def __iter__(self):
        buf: List[DataSet] = []
        count = 0
        for ds in self.base:
            buf.append(ds)
            count += ds.num_examples()
            while count >= self._batch_size:
                out, rest = DataSet.merge(buf).split_test_and_train(
                    self._batch_size)
                yield out
                buf = [rest] if rest.num_examples() else []
                count = rest.num_examples()
        if buf:
            merged = DataSet.merge(buf)
            if merged.num_examples():
                yield merged

    def batch_size(self):
        return self._batch_size


# ------------------------------------------------------------- superstep
# K batches of one signature stacked into [K, B, ...] arrays, which the
# engines train as K steps at once (`nn/superstep.py`).


class Superbatch:
    """K same-signature DataSets stacked on a new leading axis: each part
    [K, B, ...], the masks [K, B] or [K, B, T] (reference :371)."""

    def __init__(self, features, labels=None, features_mask=None,
                 labels_mask=None, k: int = 1):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self.k = int(k)

    def num_examples(self) -> int:
        return int(np.shape(self.features)[0] * np.shape(self.features)[1])

    def batch(self, j: int) -> DataSet:
        """The j-th stacked DataSet (views)."""
        return DataSet(self.features[j], _take(self.labels, j),
                       _take(self.features_mask, j),
                       _take(self.labels_mask, j))


class MultiSuperbatch:
    """K same-signature MultiDataSets stacked on a new leading axis, per
    part (reference :392)."""

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None, k: int = 1):
        self.features = list(features)
        self.labels = list(labels)
        self.features_masks = (None if features_masks is None
                               else list(features_masks))
        self.labels_masks = (None if labels_masks is None
                             else list(labels_masks))
        self.k = int(k)

    def num_examples(self) -> int:
        return int(np.shape(self.features[0])[0]
                   * np.shape(self.features[0])[1])

    def batch(self, j: int) -> MultiDataSet:
        """The j-th stacked MultiDataSet (views)."""
        def at(parts):
            return None if parts is None else [_take(a, j) for a in parts]
        return MultiDataSet(features=at(self.features),
                            labels=at(self.labels),
                            features_masks=at(self.features_masks),
                            labels_masks=at(self.labels_masks))


def _part_sig(a) -> Optional[tuple]:
    if a is None:
        return None
    dtype = a.dtype if isinstance(a, torch.Tensor) else np.asarray(a).dtype
    return (tuple(np.shape(a)), str(dtype))


def batch_signature(item) -> tuple:
    """Shapes, dtypes and mask presence of one batch (reference :417): only
    consecutive batches of one signature stack; a change flushes the
    block."""
    if isinstance(item, MultiDataSet):
        def sigs(parts):
            return None if parts is None else tuple(map(_part_sig, parts))
        return ("mds", sigs(item.features), sigs(item.labels),
                sigs(item.features_masks), sigs(item.labels_masks))
    return ("ds", _part_sig(item.features), _part_sig(item.labels),
            _part_sig(item.features_mask), _part_sig(item.labels_mask))


def batch_nbytes(item) -> int:
    """Bytes of one batch's arrays, host or device (reference :436)."""
    if isinstance(item, MultiDataSet):
        parts = list(item.features) + list(item.labels)
        for masks in (item.features_masks, item.labels_masks):
            if masks is not None:
                parts.extend(masks)
    else:
        parts = [item.features, item.labels, item.features_mask,
                 item.labels_mask]
    return sum(_staging.nbytes(a) for a in parts if a is not None)


def _stack_parts(parts: Sequence):
    """K same-shape parts stacked on a new leading axis: on the host when
    all are numpy arrays (staged afterwards in one copy), else as tensors
    where they lie (a device cache's replay stacks on the device)."""
    if parts[0] is None:
        return None
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.stack(parts)
    dev = next((p.device for p in parts if isinstance(p, torch.Tensor)),
               None)
    return torch.stack([torch.as_tensor(p, device=dev) for p in parts])


def stack_superbatch(batches: Sequence, stage: bool = True, device="cuda"):
    """K same-signature batches as a Superbatch (DataSets) or a
    MultiSuperbatch (MultiDataSets), staged to `device` with `stage`
    (reference :476)."""
    first = batches[0]
    k = len(batches)
    if isinstance(first, MultiDataSet):
        def stacked(get, n):
            return [_stack_parts([get(b)[i] for b in batches])
                    for i in range(n)]
        out = MultiSuperbatch(
            stacked(lambda b: b.features, len(first.features)),
            stacked(lambda b: b.labels, len(first.labels)),
            None if first.features_masks is None else stacked(
                lambda b: b.features_masks, len(first.features_masks)),
            None if first.labels_masks is None else stacked(
                lambda b: b.labels_masks, len(first.labels_masks)), k=k)
    else:
        out = Superbatch(*(_stack_parts([getattr(b, f) for b in batches])
                           for f in ("features", "labels", "features_mask",
                                     "labels_mask")), k=k)
    return stage_item(out, device) if stage else out


class SuperbatchIterator(DataSetIterator):
    """`base` cut into blocks of K batches for superstep training
    (reference :513). Consecutive batches of one signature stack into a
    block; a signature change or the end of the stream flushes it early,
    so the last block has its true length (no padding); a block of one
    yields the batch itself. `max_bytes` (default `DL4J_TPU_SUPERSTEP_BYTES`)
    caps a block's bytes, lowering K for large batches. Over a
    `DeviceCacheDataSetIterator` the stacked blocks are cached too, and
    built again only when the base's cache is (`invalidate`). `net` gives
    the device and the staging budget; without one, `device` (the card by
    default)."""

    def __init__(self, base: Iterable, k: int,
                 max_bytes: Optional[int] = None, stage: bool = True,
                 cache: Optional[bool] = None,
                 transform: Optional[Callable] = None,
                 transfer_dtype=None, net=None, device="cuda"):
        self.base = base
        self.k = max(1, int(k))
        self._device = device
        if max_bytes is None:
            env = os.environ.get("DL4J_TPU_SUPERSTEP_BYTES")
            max_bytes = int(env) if env else None
        self.max_bytes = max_bytes
        self.stage = stage
        self.cache = (isinstance(base, DeviceCacheDataSetIterator)
                      if cache is None else bool(cache))
        self.transform = transform
        self.transfer_dtype = transfer_dtype
        self.net = net
        self._blocks: Optional[List] = None
        self._built_from: Any = None

    @property
    def device(self):
        return self._device if self.net is None else self.net.device

    @property
    def stages_to_device(self) -> bool:
        return bool(self.stage)

    def _iter_blocks(self, stage: Optional[bool] = None) -> Iterator:
        stage = self.stage if stage is None else stage
        buf: List = []
        sig = None
        limit = self.k

        def flush():
            if len(buf) == 1:
                return buf[0]
            return stack_superbatch(buf, stage=stage, device=self.device)

        base_it = iter(self.base)
        while True:
            # The base's next timed apart: K batches make one dispatch, so
            # these waits are starvation the engine's loop cannot see.
            t_wait = time.perf_counter()
            try:
                item = next(base_it)
            except StopIteration:
                break
            _M_INPUT_WAIT.observe(time.perf_counter() - t_wait)
            _staging.ready(item)  # a staged batch's copies, before stacking
            if self.transform is not None:
                item = self.transform(item)
            if self.transfer_dtype is not None:
                item = transfer_cast(item, self.transfer_dtype)
            s = batch_signature(item)
            if buf and s != sig:
                yield flush()
                buf = []
            if not buf:
                sig = s
                limit = self.k
                if self.max_bytes is not None:
                    per = batch_nbytes(item)
                    if per > 0:
                        limit = max(1, min(self.k, self.max_bytes // per))
            buf.append(item)
            if len(buf) >= limit:
                yield flush()
                buf = []
        if buf:
            yield flush()

    def __iter__(self):
        if not self.cache:
            if self.stage and _staging.staging_enabled():
                # Blocks stacked on the stager's thread and staged there:
                # the next block crosses to the device while this one
                # trains.
                return DeviceStager(self._iter_blocks(stage=False),
                                    net=self.net, device=self.device)
            return self._iter_blocks()
        base_cache = getattr(self.base, "_cache", None)
        if self._blocks is None or self._built_from is not base_cache:
            self._blocks = list(self._iter_blocks())
            self._built_from = getattr(self.base, "_cache", None)
        return iter(self._blocks)

    def reset(self):
        maybe_reset(self.base)

    def batch_size(self):
        bs = getattr(self.base, "batch_size", None)
        return bs() if callable(bs) else None

    def total_examples(self):
        te = getattr(self.base, "total_examples", None)
        return te() if callable(te) else None
