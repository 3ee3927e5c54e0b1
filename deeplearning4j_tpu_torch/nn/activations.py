"""Activation functions of the serving slice (counterpart of
`deeplearning4j_tpu/nn/activations.py`): the names `transformer_lm` and
the norm+act kernel use."""

from __future__ import annotations

from typing import Callable

import torch

_REGISTRY: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def resolve(activation) -> Callable[[torch.Tensor], torch.Tensor]:
    """Name (any case; None = identity) -> function on tensors."""
    key = "identity" if activation is None else str(activation).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation: {activation!r}. Known in the "
                         f"port: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
