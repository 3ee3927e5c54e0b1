"""Weight initialization (counterpart of `deeplearning4j_tpu/nn/weights.py`)
for the schemes the ported models use, drawn from an explicit
`torch.Generator`. The draws differ from JAX's threefry stream for the same
seed; what matches is the distribution, and parity runs copy params."""

from __future__ import annotations

import math

import torch


def init_weights(generator: torch.Generator, shape: tuple, fan_in: float,
                 fan_out: float, scheme="xavier",
                 dtype=torch.float32) -> torch.Tensor:
    scheme = str(getattr(scheme, "value", scheme) or "xavier").lower()
    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype)
    if scheme == "xavier":
        # Reference: normal * sqrt(2 / (fan_in + fan_out)).
        return (torch.randn(shape, generator=generator, dtype=dtype)
                * math.sqrt(2.0 / (fan_in + fan_out)))
    if scheme == "relu":
        # Reference: normal * sqrt(2 / fan_in) (He init).
        return (torch.randn(shape, generator=generator, dtype=dtype)
                * math.sqrt(2.0 / fan_in))
    raise ValueError(f"weight init {scheme!r} is not in the port yet "
                     "(it has zero, ones, xavier, relu)")
