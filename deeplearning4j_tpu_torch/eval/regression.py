"""Regression evaluation (counterpart of
`deeplearning4j_tpu/eval/regression.py`, the reference's
`RegressionEvaluation`): per-column MSE, MAE, RMSE, RSE, correlation R and
R^2, accumulated in float64 on the host, mergeable. Labels, predictions
and masks may be numpy arrays or tensors on either device; a [b, t, c]
pair keeps the time steps whose mask entry is positive."""

from __future__ import annotations

from typing import Optional, Sequence

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


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None,
                 column_names: Optional[Sequence[str]] = None):
        self.column_names = list(column_names) if column_names else None
        self.n = n_columns or (len(column_names) if column_names else None)
        self._initialized = False

    def _ensure(self, n: int):
        if self._initialized:
            return
        self.n = self.n or n
        z = lambda: np.zeros(self.n, np.float64)
        self.count = z()
        self.sum_abs_err = z()
        self.sum_sq_err = z()
        self.sum_label = z()
        self.sum_label_sq = z()
        self.sum_pred = z()
        self.sum_pred_sq = z()
        self.sum_label_pred = z()
        self._initialized = True

    def eval(self, labels, predictions, mask=None):
        labels = _host(labels).astype(np.float64)
        predictions = _host(predictions).astype(np.float64)
        mask = _host(mask)
        if labels.ndim == 3:  # [b,t,c] -> flatten time with mask
            keep = (np.asarray(mask).reshape(-1) > 0) if mask is not None else \
                np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[keep]
            predictions = predictions.reshape(-1, predictions.shape[-1])[keep]
        self._ensure(labels.shape[-1])
        err = predictions - labels
        self.count += labels.shape[0]
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_sq_err += (err ** 2).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_pred_sq += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)

    def merge(self, other: "RegressionEvaluation"):
        if not getattr(other, "_initialized", False):
            return self
        if not self._initialized:
            self._ensure(other.n)
        for f in ("count", "sum_abs_err", "sum_sq_err", "sum_label", "sum_label_sq",
                  "sum_pred", "sum_pred_sq", "sum_label_pred"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        return self

    # ------------------------------------------------------------- metrics

    def mean_squared_error(self, col: int) -> float:
        return float(self.sum_sq_err[col] / self.count[col])

    def mean_absolute_error(self, col: int) -> float:
        return float(self.sum_abs_err[col] / self.count[col])

    def root_mean_squared_error(self, col: int) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def relative_squared_error(self, col: int) -> float:
        n = self.count[col]
        mean_label = self.sum_label[col] / n
        denom = self.sum_label_sq[col] - 2 * mean_label * self.sum_label[col] + n * mean_label ** 2
        return float(self.sum_sq_err[col] / denom) if denom else float("nan")

    def correlation_r2(self, col: int) -> float:
        """Pearson correlation coefficient R (reference naming quirk kept)."""
        n = self.count[col]
        num = n * self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col]
        d1 = n * self.sum_label_sq[col] - self.sum_label[col] ** 2
        d2 = n * self.sum_pred_sq[col] - self.sum_pred[col] ** 2
        den = np.sqrt(d1 * d2)
        return float(num / den) if den else float("nan")

    def r_squared(self, col: int) -> float:
        return 1.0 - self.relative_squared_error(col)

    def average_mean_squared_error(self) -> float:
        return float(np.mean([self.mean_squared_error(c) for c in range(self.n)]))

    def average_mean_absolute_error(self) -> float:
        return float(np.mean([self.mean_absolute_error(c) for c in range(self.n)]))

    def average_root_mean_squared_error(self) -> float:
        return float(np.mean([self.root_mean_squared_error(c) for c in range(self.n)]))

    def stats(self) -> str:
        names = self.column_names or [f"col{c}" for c in range(self.n)]
        lines = [f"{'Column':<12}{'MSE':>12}{'MAE':>12}{'RMSE':>12}{'RSE':>12}{'R':>10}"]
        for c in range(self.n):
            lines.append(
                f"{names[c]:<12}{self.mean_squared_error(c):>12.5g}"
                f"{self.mean_absolute_error(c):>12.5g}"
                f"{self.root_mean_squared_error(c):>12.5g}"
                f"{self.relative_squared_error(c):>12.5g}"
                f"{self.correlation_r2(c):>10.4f}"
            )
        return "\n".join(lines)
