"""ROC evaluation (counterpart of `deeplearning4j_tpu/eval/roc.py`):
`ROC`, the thresholded binary ROC (`threshold_steps` fixed thresholds,
accumulated true and false positive counts, AUC by the trapezoid rule);
`ROCMultiClass`, one against all per class; `EvaluationBinary`, per-column
counts at threshold 0.5 under an optional mask. Host numpy, mergeable;
labels, predictions and masks may be numpy arrays or tensors on either
device."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def _host(a):
    """A numpy array of `a`: a tensor from either device is read back (a
    bf16 or f16 one as f32, numpy having no bf16), anything else as
    `np.asarray` takes it."""
    if a is None or isinstance(a, np.ndarray):
        return a
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.float()
        return a.numpy()
    return np.asarray(a)


class ROC:
    """Binary ROC/AUC (positive class = column 1 of 2-col labels, or a single
    probability column)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = int(threshold_steps)
        self.thresholds = np.linspace(0.0, 1.0, threshold_steps + 1)
        self.tp = np.zeros(threshold_steps + 1, np.int64)
        self.fp = np.zeros(threshold_steps + 1, np.int64)
        self.total_pos = 0
        self.total_neg = 0

    def eval(self, labels, predictions):
        labels = _host(labels)
        predictions = _host(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:
            pos = labels[:, 1] > 0.5
            prob = predictions[:, 1]
        else:
            pos = labels.reshape(-1) > 0.5
            prob = predictions.reshape(-1)
        self.total_pos += int(pos.sum())
        self.total_neg += int((~pos).sum())
        # predicted positive at threshold t: prob > t (reference semantics)
        above = prob[None, :] > self.thresholds[:, None]
        self.tp += (above & pos[None, :]).sum(1)
        self.fp += (above & ~pos[None, :]).sum(1)

    def get_roc_curve(self) -> List[Tuple[float, float, float]]:
        """[(threshold, fpr, tpr)] sorted by threshold."""
        out = []
        for i, t in enumerate(self.thresholds):
            tpr = self.tp[i] / self.total_pos if self.total_pos else 0.0
            fpr = self.fp[i] / self.total_neg if self.total_neg else 0.0
            out.append((float(t), float(fpr), float(tpr)))
        return out

    def calculate_auc(self) -> float:
        curve = self.get_roc_curve()
        pts = sorted([(fpr, tpr) for _, fpr, tpr in curve]) + [(1.0, 1.0)]
        pts = [(0.0, 0.0)] + pts
        auc = 0.0
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            auc += (x1 - x0) * (y0 + y1) / 2.0
        return float(auc)

    def merge(self, other: "ROC"):
        if other.threshold_steps != self.threshold_steps:
            raise ValueError("Cannot merge ROC with different threshold steps")
        self.tp += other.tp
        self.fp += other.fp
        self.total_pos += other.total_pos
        self.total_neg += other.total_neg
        return self


class ROCMultiClass:
    """One-vs-all ROC per class (reference: `eval/ROCMultiClass.java`)."""

    def __init__(self, threshold_steps: int = 30):
        self.threshold_steps = threshold_steps
        self._rocs: Dict[int, ROC] = {}

    def eval(self, labels, predictions):
        labels = _host(labels)
        predictions = _host(predictions)
        for c in range(labels.shape[1]):
            roc = self._rocs.setdefault(c, ROC(self.threshold_steps))
            roc.eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs.values()]))

    def merge(self, other: "ROCMultiClass"):
        for c, roc in other._rocs.items():
            if c in self._rocs:
                self._rocs[c].merge(roc)
            else:
                self._rocs[c] = roc
        return self


class EvaluationBinary:
    """Per-output binary metrics for multi-label outputs (reference:
    `eval/EvaluationBinary.java`): counts at threshold 0.5 per column."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = n_columns
        self._initialized = False

    def _ensure(self, n):
        if self._initialized:
            return
        self.n = self.n or n
        self.tp = np.zeros(self.n, np.int64)
        self.fp = np.zeros(self.n, np.int64)
        self.tn = np.zeros(self.n, np.int64)
        self.fn = np.zeros(self.n, np.int64)
        self._initialized = True

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels) > 0.5
        preds = _host(predictions) > 0.5
        self._ensure(labels.shape[-1])
        if mask is not None:
            m = _host(mask) > 0
            if m.ndim < labels.ndim:
                m = m[..., None]
            valid = np.broadcast_to(m, labels.shape)
        else:
            valid = np.ones_like(labels, bool)
        labels = labels.reshape(-1, self.n)
        preds = preds.reshape(-1, self.n)
        valid = valid.reshape(-1, self.n)
        self.tp += (valid & labels & preds).sum(0)
        self.fp += (valid & ~labels & preds).sum(0)
        self.tn += (valid & ~labels & ~preds).sum(0)
        self.fn += (valid & labels & ~preds).sum(0)

    def accuracy(self, col: int) -> float:
        tot = self.tp[col] + self.fp[col] + self.tn[col] + self.fn[col]
        return float((self.tp[col] + self.tn[col]) / tot) if tot else 0.0

    def precision(self, col: int) -> float:
        d = self.tp[col] + self.fp[col]
        return float(self.tp[col] / d) if d else 0.0

    def recall(self, col: int) -> float:
        d = self.tp[col] + self.fn[col]
        return float(self.tp[col] / d) if d else 0.0

    def f1(self, col: int) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def merge(self, other: "EvaluationBinary"):
        if not getattr(other, "_initialized", False):
            return self
        if not self._initialized:
            self._ensure(other.n)
        self.tp += other.tp
        self.fp += other.fp
        self.tn += other.tn
        self.fn += other.fn
        return self
