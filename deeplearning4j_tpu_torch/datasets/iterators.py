"""Dataset iterators (counterpart of the first part of
`deeplearning4j_tpu/datasets/iterators.py`, `:53-153`): `maybe_reset`,
the `DataSetIterator` protocol and `ListDataSetIterator`, minibatches of
host numpy arrays that `fit` and `evaluate` move to the net's device one
batch at a time. Background prefetch, device caches, superbatches and
staging are not in the port yet (ROADMAP A.10)."""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

_log = logging.getLogger(__name__)


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
