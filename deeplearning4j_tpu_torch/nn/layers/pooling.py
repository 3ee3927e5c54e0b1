"""Global pooling (counterpart of `deeplearning4j_tpu/nn/layers/pooling.py`
`global_pooling_apply`), the 4-D branch: [B, H, W, C] -> [B, C] over space.
Sequence pooling with masks is not in the port yet."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.enums import PoolingType


def global_pooling_apply(conf, params, state, x, train=False, mask=None):
    if x.dim() != 4:
        raise ValueError(f"GlobalPoolingLayer in the port takes [b, h, w, c] "
                         f"input, got {x.dim()}-D")
    ptype = PoolingType.of(conf.pooling_type) or PoolingType.MAX
    axes = (1, 2)
    if ptype == PoolingType.MAX:
        out = x.amax(dim=axes)
    elif ptype == PoolingType.SUM:
        out = x.sum(dim=axes)
    elif ptype == PoolingType.AVG:
        out = x.mean(dim=axes)
    elif ptype == PoolingType.PNORM:
        p = float(conf.pnorm)
        out = (x.abs() ** p).sum(dim=axes) ** (1.0 / p)
    else:
        raise ValueError(f"Unsupported global pooling type: "
                         f"{conf.pooling_type}")
    return out, state
