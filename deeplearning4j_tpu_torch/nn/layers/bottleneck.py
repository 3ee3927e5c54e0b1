"""The fused ResNet bottleneck layer (counterpart of
`deeplearning4j_tpu/nn/layers/bottleneck.py`): one call of the
`bottleneck_block` seam (`kernels/bottleneck_block.py`). In training the
batch statistics come back from it and the EMA runs here, as in
`batchnorm_apply` (bottleneck.py:17-29): decay * state + (1 - decay) *
stat, on detached statistics."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import bottleneck_block as _kernel


def bottleneck_apply(conf, params, state, x, train=False, mask=None,
                     rng=None):
    out, stats = _kernel.bottleneck_forward(
        x, params, state, stride=conf.stride, project=conf.project,
        eps=conf.eps, activation=conf.activation,
        train=bool(train) and conf.is_minibatch)
    if stats is None:
        return out, state
    decay = conf.decay
    with torch.no_grad():
        new_state = {k: decay * state[k] + (1.0 - decay) * stats[k].detach()
                     for k in stats}
    return out, new_state
