"""Classification evaluation (counterpart of
`deeplearning4j_tpu/eval/evaluation.py`, the reference's `Evaluation` and
`ConfusionMatrix`): accuracy, precision, recall, F1 and top-N accuracy
from a confusion matrix, counted in host numpy. Labels are one-hot or
integer class ids; predictions are probabilities; [b, c] or, with an
optional [b, t] mask, [b, t, c]. Tensors are read back to the host."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _host(a):
    if a is None or isinstance(a, np.ndarray):
        return a
    if hasattr(a, "detach"):  # a tensor, possibly on the card
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    return np.asarray(a)


class ConfusionMatrix:
    """Counts [actual, predicted]."""

    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def merge(self, other: "ConfusionMatrix"):
        self.matrix += other.matrix


class Evaluation:
    """Accumulating classification metrics (see the module docstring)."""

    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1,
                 labels: Optional[Sequence[str]] = None):
        self.num_classes = num_classes
        self.label_names = list(labels) if labels else None
        self.top_n = top_n
        self.confusion: Optional[ConfusionMatrix] = None
        self.top_n_correct = 0
        self.total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None):
        """Count one batch (masked rows or steps left out)."""
        labels, predictions, mask = (_host(labels), _host(predictions),
                                     _host(mask))
        sparse = (np.issubdtype(labels.dtype, np.integer)
                  and labels.ndim == predictions.ndim - 1)
        if sparse:
            c = predictions.shape[-1]
            if labels.size and (labels.min() < 0 or labels.max() >= c):
                raise ValueError(f"class ids must be in [0, {c}); got "
                                 f"[{labels.min()}, {labels.max()}]")
        if predictions.ndim == 3:
            keep = (mask.reshape(-1) > 0 if mask is not None else
                    np.ones(predictions.shape[0] * predictions.shape[1],
                            bool))
            labels = (labels.reshape(-1)[keep] if sparse
                      else labels.reshape(-1, labels.shape[-1])[keep])
            predictions = predictions.reshape(-1, predictions.shape[-1])[keep]
        elif mask is not None:
            keep = mask.reshape(-1) > 0
            labels, predictions = labels[keep], predictions[keep]
        self._ensure(predictions.shape[-1])
        actual = (labels.astype(np.int64) if sparse
                  else np.argmax(labels, axis=-1))
        pred = np.argmax(predictions, axis=-1)
        np.add.at(self.confusion.matrix, (actual, pred), 1)
        self.total += len(actual)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int(np.sum(top == actual[:, None]))
        else:
            self.top_n_correct += int(np.sum(actual == pred))

    # ------------------------------------------------------------- metrics

    def _tp(self, c) -> int:
        return self.confusion.get_count(c, c)

    def _fp(self, c) -> int:
        return int(self.confusion.matrix[:, c].sum() - self._tp(c))

    def _fn(self, c) -> int:
        return int(self.confusion.matrix[c, :].sum() - self._tp(c))

    def accuracy(self) -> float:
        if self.total == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / self.total

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.total if self.total else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / denom if denom else 0.0
        return float(np.mean([self.precision(c)
                              for c in range(self.num_classes)]))

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / denom if denom else 0.0
        return float(np.mean([self.recall(c)
                              for c in range(self.num_classes)]))

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        tn = self.total - self._tp(cls) - self._fp(cls) - self._fn(cls)
        denom = self._fp(cls) + tn
        return self._fp(cls) / denom if denom else 0.0

    def merge(self, other: "Evaluation"):
        """Add another evaluation's counts."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self.num_classes = other.num_classes
            self.confusion = ConfusionMatrix(other.num_classes)
        self.confusion.merge(other.confusion)
        self.total += other.total
        self.top_n_correct += other.top_n_correct
        return self

    def stats(self) -> str:
        lines = [
            "=" * 24 + "Evaluation Metrics" + "=" * 24,
            f" # of classes:  {self.num_classes}",
            f" Examples:      {self.total}",
            f" Accuracy:      {self.accuracy():.4f}",
            f" Precision:     {self.precision():.4f}",
            f" Recall:        {self.recall():.4f}",
            f" F1 Score:      {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} acc:   "
                         f"{self.top_n_accuracy():.4f}")
        lines.append("=" * 66)
        return "\n".join(lines)
