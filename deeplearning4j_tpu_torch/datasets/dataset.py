"""DataSet / MultiDataSet containers (the port's copy of
`deeplearning4j_tpu/datasets/dataset.py`, which is pure numpy).

Equivalent of ND4J's `DataSet`/`MultiDataSet` (features, labels, optional
feature/label masks) consumed by every `fit()` path. Arrays are host numpy
(or tensors) until the engine moves them to its device.

Layouts: features [b, f] | [b, t, f] | [b, h, w, c]; masks [b, t].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (
            DataSet(
                self.features[:n_train],
                None if self.labels is None else self.labels[:n_train],
                None if self.features_mask is None else self.features_mask[:n_train],
                None if self.labels_mask is None else self.labels_mask[:n_train],
            ),
            DataSet(
                self.features[n_train:],
                None if self.labels is None else self.labels[n_train:],
                None if self.features_mask is None else self.features_mask[n_train:],
                None if self.labels_mask is None else self.labels_mask[n_train:],
            ),
        )

    def shuffle(self, seed: Optional[int] = None):
        rng = np.random.RandomState(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        n = self.num_examples()
        return [
            DataSet(
                self.features[i : i + batch_size],
                None if self.labels is None else self.labels[i : i + batch_size],
                None if self.features_mask is None else self.features_mask[i : i + batch_size],
                None if self.labels_mask is None else self.labels_mask[i : i + batch_size],
            )
            for i in range(0, n, batch_size)
        ]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(parts):
            if any(p is None for p in parts):
                return None
            return np.concatenate(parts, axis=0)

        return DataSet(
            cat([d.features for d in datasets]),
            cat([d.labels for d in datasets]),
            cat([d.features_mask for d in datasets]),
            cat([d.labels_mask for d in datasets]),
        )


@dataclass
class MultiDataSet:
    """Multiple features/labels arrays (reference: ND4J MultiDataSet, consumed
    by ComputationGraph.fit)."""

    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: DataSet) -> "MultiDataSet":
        return MultiDataSet(
            features=[ds.features],
            labels=[ds.labels] if ds.labels is not None else [],
            features_masks=[ds.features_mask] if ds.features_mask is not None else None,
            labels_masks=[ds.labels_mask] if ds.labels_mask is not None else None,
        )
