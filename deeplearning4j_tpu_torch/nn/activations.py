"""Activation functions (counterpart of
`deeplearning4j_tpu/nn/activations.py`): the reference's whole set, by the
same names and with the same formulas (gelu is JAX's default tanh
approximation), and the reference's two ways past it: a callable passes
through `resolve` as it is, and `register(name, fn)` adds a name (any case)
that a conf then names like a built-in one, so the name, not the function,
travels in the conf's JSON. `builtin(activation)` says whether a spec is
one of the built-in functions under its own name: the kernels that take an
activation by code (`kernels/lstm_cell.py`) run only those, and a name
registered over a built-in one is the user's function, not the built-in's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _rational_tanh(x):
    # ND4J RationalTanh: 1.7159 * tanh_approx(2x/3) with
    # tanh_approx(y) = sign(y) * (1 - 1 / (1 + |y| + y^2 + 1.41645 y^4)).
    y = 2.0 * x / 3.0
    a = torch.abs(y)
    approx = torch.sign(y) * (1.0 - 1.0 / (1.0 + a + y * y
                                           + 1.41645 * (y ** 4)))
    return 1.7159 * approx


_REGISTRY: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
    "cube": lambda x: x ** 3,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "rationaltanh": _rational_tanh,
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "hardsigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "selu": torch.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "swish": F.silu,
}


_BUILTIN = dict(_REGISTRY)


def resolve(activation) -> Callable[[torch.Tensor], torch.Tensor]:
    """Name (any case; None = identity) or callable -> function on
    tensors (reference `resolve`, activations.py:54-64)."""
    if callable(activation) and not isinstance(activation, str):
        return activation
    key = "identity" if activation is None else str(activation).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation: {activation!r}. Known in the "
                         f"port: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def register(name: str, fn: Callable[[torch.Tensor], torch.Tensor]) -> None:
    """Add (or replace) the activation `name`, any case (reference
    `register`, activations.py:67-69)."""
    _REGISTRY[str(name).lower()] = fn


def builtin(activation):
    """The built-in name of `activation` (None = identity) when the
    registry still maps it to the built-in function, else None (a
    callable, a registered name, or a built-in name registered over)."""
    if callable(activation) and not isinstance(activation, str):
        return None
    key = "identity" if activation is None else str(activation).lower()
    fn = _REGISTRY.get(key)
    return key if fn is not None and fn is _BUILTIN.get(key) else None
