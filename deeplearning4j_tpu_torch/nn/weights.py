"""Weight initialization (counterpart of `deeplearning4j_tpu/nn/weights.py`):
the reference's 17 schemes, drawn from an explicit `torch.Generator`. The
draws differ from JAX's threefry stream for the same seed; what matches is
the distribution, and parity runs copy params.

Fans follow the reference (dense: fan_in = n_in, fan_out = n_out; an HWIO
conv kernel: fan_in = cin * kh * kw, fan_out = cout * kh * kw). The legacy
schemes (`xavier_legacy`, `normalized`, `vi`) read the shape itself
(`shape[0]`, `shape[:2]`), so they depend on the layout: params are drawn
in the reference's layouts (HWIO kernels), never transposed first."""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import WeightInit


def _uniform(generator, shape, dtype, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       dtype=dtype)


def init_weights(generator: torch.Generator, shape: tuple, fan_in: float,
                 fan_out: float, scheme="xavier", distribution=None,
                 dtype=torch.float32) -> torch.Tensor:
    shape = tuple(shape)
    scheme = WeightInit.of(scheme) or "xavier"

    def normal():
        return torch.randn(shape, generator=generator, dtype=dtype)

    def uniform(a):
        return _uniform(generator, shape, dtype, -a, a)

    if scheme == "zero":
        return torch.zeros(shape, dtype=dtype)
    if scheme == "ones":
        return torch.ones(shape, dtype=dtype)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("weight init 'identity' needs a square 2-D "
                             f"shape, got {shape}")
        return torch.eye(shape[0], dtype=dtype)
    if scheme == "distribution":
        if distribution is None:
            raise ValueError("weight init 'distribution' needs a "
                             "distribution (the layer's or the global dist)")
        return distribution.sample(generator, shape, dtype)
    if scheme == "uniform":
        return uniform(1.0 / math.sqrt(max(fan_in, 1.0)))
    if scheme == "xavier":
        return normal() * math.sqrt(2.0 / (fan_in + fan_out))
    if scheme in ("xavier_uniform", "size"):
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if scheme == "xavier_fan_in":
        return normal() / math.sqrt(fan_in)
    if scheme == "xavier_legacy":
        return normal() / math.sqrt(sum(shape[:2]) if len(shape) >= 2
                                    else shape[0])
    if scheme == "relu":
        return normal() * math.sqrt(2.0 / fan_in)
    if scheme == "relu_uniform":
        return uniform(math.sqrt(6.0 / fan_in))
    if scheme == "sigmoid_uniform":
        return uniform(4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    if scheme == "lecun_normal":
        return normal() * math.sqrt(1.0 / fan_in)
    if scheme == "lecun_uniform":
        return uniform(math.sqrt(3.0 / fan_in))
    if scheme == "normalized":
        return (_uniform(generator, shape, dtype, 0.0, 1.0) - 0.5) / shape[0]
    # "vi": the reference's legacy variance-normalized init.
    return uniform(math.sqrt(6.0 / (sum(shape[:2]) if len(shape) >= 2
                                    else shape[0] + 1)))
