"""Gradient updaters (counterpart of `deeplearning4j_tpu/ops/updaters.py`).

Each updater is an (init, update) pair over one layer's `{name: tensor}`
params: `init(params)` gives the state (`{field: {name: tensor}}`, `{}`
for the stateless ones) and `update(state, grads, lr, step)` returns
`(new_state, deltas)`; the caller applies `params - deltas`. `lr` is a
host float and `step` the host iteration count, so a step needs no sync.

Adam, Nesterovs and RMSProp go through the fused-update seam
(`kernels/fused_update.py`: the CUDA kernel on the card, which updates the
state in place; the reference's XLA bodies on the CPU), and name their
`(kind, hyper)` in `fused`, by which the training engine updates all their
layers at once (`fused_update.apply_step`). The other five are the
reference's per-leaf expressions in torch ops.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import fused_update as _fused

UPDATERS = ("sgd", "none", "nesterovs", "adam", "adamax", "adagrad",
            "adadelta", "rmsprop")


class GradientUpdater(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]
    # (kind, hyper) of the updaters with a fused-update body: the engine
    # updates all the layers of one such pair with one `apply_step`.
    fused: Optional[Tuple[str, tuple]] = None


def _zeros_like(params):
    return {k: torch.zeros_like(p, requires_grad=False)
            for k, p in params.items()}


def sgd() -> GradientUpdater:
    def update(state, grads, lr, step):
        return state, {k: lr * g for k, g in grads.items()}

    return GradientUpdater("sgd", lambda params: {}, update)


def none_updater() -> GradientUpdater:
    def update(state, grads, lr, step):
        return state, {k: torch.zeros_like(g) for k, g in grads.items()}

    return GradientUpdater("none", lambda params: {}, update)


def _fused_updater(kind, fields, hyper) -> GradientUpdater:
    def init(params):
        return {f: _zeros_like(params) for f in fields}

    def update(state, grads, lr, step):
        return _fused.dispatch(kind, state, grads, lr, step, hyper)

    return GradientUpdater(kind, init, update, (kind, tuple(hyper)))


def nesterovs(momentum: float = 0.9) -> GradientUpdater:
    """Nesterov momentum, ND4J semantics (see `fused_update.nesterovs_xla`)."""
    return _fused_updater("nesterovs", ("v",), (momentum,))


def adam(beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-8) -> GradientUpdater:
    return _fused_updater("adam", ("m", "v"), (beta1, beta2, eps))


def rmsprop(decay: float = 0.95, eps: float = 1e-8) -> GradientUpdater:
    return _fused_updater("rmsprop", ("g2",), (decay, eps))


def adamax(beta1: float = 0.9, beta2: float = 0.999,
           eps: float = 1e-8) -> GradientUpdater:
    def init(params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    def update(state, grads, lr, step):
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(beta1) ** t)
        lr = float(np.float32(lr))
        m = {k: beta1 * state["m"][k] + (1 - beta1) * g
             for k, g in grads.items()}
        u = {k: torch.maximum(beta2 * state["u"][k], g.abs())
             for k, g in grads.items()}
        deltas = {k: lr * (m[k] / bc1) / (u[k] + eps) for k in grads}
        return {"m": m, "u": u}, deltas

    return GradientUpdater("adamax", init, update)


def adagrad(eps: float = 1e-6) -> GradientUpdater:
    def update(state, grads, lr, step):
        lr = float(np.float32(lr))
        h = {k: state["h"][k] + g * g for k, g in grads.items()}
        deltas = {k: lr * g / (torch.sqrt(h[k]) + eps)
                  for k, g in grads.items()}
        return {"h": h}, deltas

    return GradientUpdater("adagrad", lambda p: {"h": _zeros_like(p)}, update)


def adadelta(rho: float = 0.95, eps: float = 1e-6) -> GradientUpdater:
    """AdaDelta ignores the learning rate, as the reference does."""

    def init(params):
        return {"msg": _zeros_like(params), "msdx": _zeros_like(params)}

    def update(state, grads, lr, step):
        msg = {k: rho * state["msg"][k] + (1 - rho) * g * g
               for k, g in grads.items()}
        deltas = {k: g * torch.sqrt(state["msdx"][k] + eps)
                  / torch.sqrt(msg[k] + eps) for k, g in grads.items()}
        msdx = {k: rho * state["msdx"][k] + (1 - rho) * deltas[k] * deltas[k]
                for k in grads}
        return {"msg": msg, "msdx": msdx}, deltas

    return GradientUpdater("adadelta", init, update)


def create(updater, *, momentum=0.9, adam_mean_decay=0.9,
           adam_var_decay=0.999, rho=0.95, rms_decay=0.95,
           epsilon=None) -> GradientUpdater:
    """An updater from its name and hyperparameters, with the reference's
    per-updater default epsilons (`LayerUpdater.java:240-272`)."""
    u = "sgd" if updater is None else str(updater).lower()
    if u == "sgd":
        return sgd()
    if u == "none":
        return none_updater()
    if u == "nesterovs":
        return nesterovs(momentum)
    if u == "adam":
        return adam(adam_mean_decay, adam_var_decay,
                    1e-8 if epsilon is None else epsilon)
    if u == "adamax":
        return adamax(adam_mean_decay, adam_var_decay,
                      1e-8 if epsilon is None else epsilon)
    if u == "adagrad":
        return adagrad(1e-6 if epsilon is None else epsilon)
    if u == "adadelta":
        return adadelta(rho, 1e-6 if epsilon is None else epsilon)
    if u == "rmsprop":
        return rmsprop(rms_decay, 1e-8 if epsilon is None else epsilon)
    raise ValueError(f"Unknown updater: {updater!r} (known: {UPDATERS})")
