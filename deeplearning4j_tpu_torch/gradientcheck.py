"""Finite-difference gradient checks (counterpart of
`deeplearning4j_tpu/gradientcheck.py`, the reference's
`GradientCheckUtil`): central differences (C(w + eps) - C(w - eps)) / 2 eps
per parameter against the autograd gradient, for a MultiLayerNetwork or a
ComputationGraph.

The score is the engine's deterministic objective (`_objective`: no
dropout, BatchNorm's running statistics, the reference's
`_score_fn_multilayer` and `_score_fn_graph`), on the net's own device: on
the card its forward runs the port's kernels, so a float64 net (`.dtype(
"float64")`, as every gradient check should be built) runs their float64
forms. The parameters are walked in the reference's flat order (keys
sorted at each level, as `jax.tree_util.tree_flatten` orders a dict), so
`subset` draws the same indices from `seed`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet


def _item(net, data):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(net, MultiLayerNetwork):
        return data if isinstance(data, DataSet) else DataSet(*data)
    return (data if isinstance(data, MultiDataSet)
            else MultiDataSet.from_dataset(data))


def check_gradients(net, data, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    print_results: bool = False, subset: Optional[int] = None,
                    seed: int = 12345) -> bool:
    """True if every checked parameter's relative error is under
    `max_rel_error`; a parameter whose absolute error is under
    `min_abs_error` passes whatever its relative error (reference
    `check_gradients`, :58). `subset`: check only that many parameters,
    drawn without replacement from `RandomState(seed)`."""
    item = _item(net, data)
    keys = net._flat_keys()
    leaves = [net.params_tree[v][k] for v, k in keys]
    shapes = [t.shape for t in leaves]
    sizes = [t.numel() for t in leaves]

    def tree(parts):
        out = {}
        for (v, k), part in zip(keys, parts):
            out.setdefault(v, {})[k] = part
        return out

    with torch.inference_mode(False), torch.enable_grad():
        var = [t.detach().clone().requires_grad_(True) for t in leaves]
        loss = net._objective(tree(var), item)
        grads = torch.autograd.grad(loss, var, allow_unused=True)
    analytic = np.concatenate([
        (np.zeros(n) if g is None else g.detach().cpu().double().numpy()
         ).reshape(-1) for g, n in zip(grads, sizes)])
    flat = np.concatenate([t.detach().cpu().double().numpy().reshape(-1)
                           for t in leaves])
    n = flat.size
    idxs = np.arange(n)
    if subset is not None and subset < n:
        idxs = np.random.RandomState(seed).choice(n, subset, replace=False)

    dev, dt = leaves[0].device, leaves[0].dtype

    def score(vec) -> float:
        whole = torch.from_numpy(vec).to(dev, dt)
        parts = [p.reshape(s) for p, s in zip(torch.split(whole, sizes),
                                              shapes)]
        with torch.no_grad():
            return float(net._objective(tree(parts), item))

    n_pass = n_fail = 0
    max_err_seen = 0.0
    for i in idxs:
        orig = flat[i]
        flat[i] = orig + epsilon
        plus = score(flat)
        flat[i] = orig - epsilon
        minus = score(flat)
        flat[i] = orig
        numeric = (plus - minus) / (2 * epsilon)
        a = analytic[i]
        abs_err = abs(a - numeric)
        denom = abs(a) + abs(numeric)
        rel_err = abs_err / denom if denom > 0 else 0.0
        ok = rel_err < max_rel_error or abs_err < min_abs_error
        max_err_seen = max(max_err_seen,
                           rel_err if abs_err >= min_abs_error else 0.0)
        if ok:
            n_pass += 1
        else:
            n_fail += 1
            if print_results:
                print(f"param[{i}] FAIL analytic={a:.8g} "
                      f"numeric={numeric:.8g} relErr={rel_err:.4g}")
    if print_results:
        print(f"GradientCheck: {n_pass} passed, {n_fail} failed, "
              f"maxRelErr={max_err_seen:.4g}")
    return n_fail == 0
