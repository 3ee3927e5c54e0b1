"""Normalization layers (counterpart of
`deeplearning4j_tpu/nn/layers/normalization.py`): layer norm, per-row
statistics through the norm+act kernel; batch norm, the given or batch
statistics through the BatchNorm apply kernel. Layer norm takes input
dropout at train time (`common.py`), as the reference's does.

Layer signature: see `nn/layers/__init__.py`."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels.norm_act import (
    batchnorm_norm_act,
    layernorm_norm_act,
)
from deeplearning4j_tpu_torch.nn.layers.common import layer_input_dropout


def layernorm_apply(conf, params, state, x, train=False, mask=None,
                    rng=None):
    x = layer_input_dropout(conf, x, rng, train)
    out = layernorm_norm_act(x, params["gamma"], params["beta"], conf.eps,
                             conf.activation)
    return out, state


def batchnorm_apply(conf, params, state, x, train=False, mask=None,
                    rng=None):
    """Reference `batchnorm_apply` (normalization.py:19-45): in training
    (with `is_minibatch`) single-pass batch statistics over every axis but
    the last, mean(x) and mean(x*x) - mean^2, computed inside autograd so
    the gradient flows through them; the running statistics move by the EMA
    decay * state + (1 - decay) * stat, on detached values (a bf16 stat
    promotes to the f32 state there). In inference the running statistics
    are used as they are (f32: with a bf16 x the plain path computes in f32,
    as XLA does). `lock_gamma_beta` uses the conf's constants."""
    if train and conf.is_minibatch:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = (x * x).mean(dim=axes) - mean * mean
        decay = conf.decay
        with torch.no_grad():
            new_state = {
                "mean": decay * state["mean"] + (1.0 - decay) * mean.detach(),
                "var": decay * state["var"] + (1.0 - decay) * var.detach(),
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    if conf.lock_gamma_beta or not params:
        gamma, beta = conf.gamma, conf.beta
    else:
        gamma, beta = params["gamma"], params["beta"]
    out = batchnorm_norm_act(x, mean, var, gamma, beta, conf.eps,
                             conf.activation)
    return out, new_state
