"""Global pooling (counterpart of `deeplearning4j_tpu/nn/layers/pooling.py`
`global_pooling_apply`): [B, H, W, C] -> [B, C] over space, [B, T, F] ->
[B, F] over time. Sequence pooling under a mask is not in the port yet
(ROADMAP A.4)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.enums import PoolingType


def global_pooling_apply(conf, params, state, x, train=False, mask=None):
    if x.dim() == 3 and mask is not None:
        raise NotImplementedError("GlobalPoolingLayer under a mask is not in "
                                  "the port yet (ROADMAP A.4)")
    if x.dim() not in (3, 4):
        raise ValueError(f"GlobalPoolingLayer takes [b, t, f] or "
                         f"[b, h, w, c] input, got {x.dim()}-D")
    ptype = PoolingType.of(conf.pooling_type) or PoolingType.MAX
    axes = (1,) if x.dim() == 3 else (1, 2)
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
