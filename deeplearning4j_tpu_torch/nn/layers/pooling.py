"""Global pooling (counterpart of `deeplearning4j_tpu/nn/layers/pooling.py`
`global_pooling_apply`): [B, H, W, C] -> [B, C] over space, [B, T, F] ->
[B, F] over time, a [B, T] features mask leaving the masked steps out (a
fully masked row pools to -inf under MAX, to 0 otherwise, as in the
reference). The mask is consumed: the engines give the next layer none
(`nn/layers/__init__.py` `mask_after`)."""

from __future__ import annotations

import math

from deeplearning4j_tpu_torch.nn.conf.enums import PoolingType


def global_pooling_apply(conf, params, state, x, train=False, mask=None,
                         rng=None):
    if x.dim() not in (3, 4):
        raise ValueError(f"GlobalPoolingLayer takes [b, t, f] or "
                         f"[b, h, w, c] input, got {x.dim()}-D")
    ptype = PoolingType.of(conf.pooling_type) or PoolingType.MAX
    axes = (1,) if x.dim() == 3 else (1, 2)
    m = mask[..., None] if x.dim() == 3 and mask is not None else None
    if ptype == PoolingType.MAX:
        if m is not None:
            x = x.masked_fill(~(m > 0), -math.inf)
        out = x.amax(dim=axes)
    elif ptype == PoolingType.SUM:
        out = (x if m is None else x * m).sum(dim=axes)
    elif ptype == PoolingType.AVG:
        if m is None:
            out = x.mean(dim=axes)
        else:
            out = (x * m).sum(dim=axes) / m.sum(dim=axes).clamp_min(1.0)
    elif ptype == PoolingType.PNORM:
        p = float(conf.pnorm)
        if m is not None:
            x = x * m
        out = (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
    else:
        raise ValueError(f"Unsupported global pooling type: "
                         f"{conf.pooling_type}")
    return out, state
