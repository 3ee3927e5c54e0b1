"""The port's `RegressionEvaluation`, `ROC`, `ROCMultiClass` and
`EvaluationBinary` (`deeplearning4j_tpu_torch/eval/`) against the JAX
package's on the same seeded data: every metric equal to 1e-12 relative
(both accumulate in float64 on the host, the port from tensors as well as
arrays), masks and merges included."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval import regression as jax_regression
from deeplearning4j_tpu.eval import roc as jax_roc
from deeplearning4j_tpu_torch.eval import regression, roc

TIGHT = dict(rtol=1e-12, atol=1e-15)


def _as(kind, a):
    if a is None or kind == "numpy":
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16).float() if kind == "bf16" else t


def _data(seed, shape, classes=3):
    rng = np.random.RandomState(seed)
    labels = np.eye(classes)[rng.randint(0, classes, shape)]
    logits = rng.randn(*shape, classes) + 1.5 * labels
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return labels.astype(np.float32), probs.astype(np.float32)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("masked", [False, True])
def test_regression_matches_the_reference(kind, masked):
    rng = np.random.RandomState(3)
    y = rng.randn(4, 6, 3).astype(np.float32)
    p = (y + 0.3 * rng.randn(4, 6, 3)).astype(np.float32)
    m = (rng.rand(4, 6) < 0.7).astype(np.float32) if masked else None
    want = jax_regression.RegressionEvaluation()
    want.eval(y, p, mask=m)
    want.eval(y[:, :2], p[:, :2])  # a second batch, [b, t, c] unmasked
    got = regression.RegressionEvaluation()
    got.eval(_as(kind, y), _as(kind, p), mask=_as(kind, m))
    got.eval(_as(kind, y[:, :2]), _as(kind, p[:, :2]))
    for c in range(3):
        for metric in ("mean_squared_error", "mean_absolute_error",
                       "root_mean_squared_error", "relative_squared_error",
                       "correlation_r2", "r_squared"):
            np.testing.assert_allclose(getattr(got, metric)(c),
                                       getattr(want, metric)(c), **TIGHT)
    np.testing.assert_allclose(got.average_mean_squared_error(),
                               want.average_mean_squared_error(), **TIGHT)
    assert got.stats() == want.stats()


def test_regression_merge_matches_the_reference():
    rng = np.random.RandomState(4)
    parts = [(rng.randn(5, 2), rng.randn(5, 2)) for _ in range(3)]
    want, got = jax_regression.RegressionEvaluation(), \
        regression.RegressionEvaluation()
    for y, p in parts[:2]:
        want.eval(y, p)
        got.eval(torch.from_numpy(y), torch.from_numpy(p))
    wo, go = jax_regression.RegressionEvaluation(), \
        regression.RegressionEvaluation()
    wo.eval(*parts[2])
    go.eval(*parts[2])
    want.merge(wo)
    got.merge(go)
    for c in range(2):
        np.testing.assert_allclose(got.r_squared(c), want.r_squared(c),
                                   **TIGHT)


@pytest.mark.parametrize("steps", [10, 30])
@pytest.mark.parametrize("form", ["two_column", "one_column"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_roc_matches_the_reference(steps, form, kind):
    labels, probs = _data(5, (40,), classes=2)
    if form == "one_column":
        labels, probs = labels[:, 1:], probs[:, 1:]
    want, got = jax_roc.ROC(steps), roc.ROC(steps)
    want.eval(labels, probs)
    got.eval(_as(kind, labels), _as(kind, probs))
    assert got.calculate_auc() == want.calculate_auc()
    assert got.get_roc_curve() == want.get_roc_curve()
    other_w, other_g = jax_roc.ROC(steps), roc.ROC(steps)
    l2, p2 = _data(6, (17,), classes=2)
    if form == "one_column":
        l2, p2 = l2[:, 1:], p2[:, 1:]
    other_w.eval(l2, p2)
    other_g.eval(l2, p2)
    assert (got.merge(other_g).calculate_auc()
            == want.merge(other_w).calculate_auc())


@pytest.mark.parametrize("kind", ["numpy", "tensor", "bf16"])
def test_roc_multiclass_matches_the_reference(kind):
    labels, probs = _data(7, (64,), classes=4)
    want, got = jax_roc.ROCMultiClass(20), roc.ROCMultiClass(20)
    want.eval(labels, _as(kind, probs).numpy() if kind == "bf16" else probs)
    got.eval(_as(kind, labels), _as(kind, probs))
    for c in range(4):
        assert got.calculate_auc(c) == want.calculate_auc(c)
    assert got.calculate_average_auc() == want.calculate_average_auc()


@pytest.mark.parametrize("shape", [(30,), (6, 5)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_evaluation_binary_matches_the_reference(shape, masked, kind):
    rng = np.random.RandomState(8)
    labels = (rng.rand(*shape, 3) < 0.4).astype(np.float32)
    preds = rng.rand(*shape, 3).astype(np.float32)
    mask = (rng.rand(*shape) < 0.6).astype(np.float32) if masked else None
    want, got = jax_roc.EvaluationBinary(), roc.EvaluationBinary()
    want.eval(labels, preds, mask=mask)
    got.eval(_as(kind, labels), _as(kind, preds), mask=_as(kind, mask))
    for f in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for c in range(3):
        for metric in ("accuracy", "precision", "recall", "f1"):
            assert getattr(got, metric)(c) == getattr(want, metric)(c)
    other_w, other_g = jax_roc.EvaluationBinary(), roc.EvaluationBinary()
    other_w.eval(labels[:2], preds[:2])
    other_g.eval(labels[:2], preds[:2])
    want.merge(other_w)
    got.merge(other_g)
    np.testing.assert_array_equal(got.tp, want.tp)
