"""Layer normalization (counterpart of
`deeplearning4j_tpu/nn/layers/normalization.py::layernorm_apply`): per-row
statistics, normalize, affine and activation through the norm+act kernel."""

from __future__ import annotations

from deeplearning4j_tpu_torch.kernels.norm_act import layernorm_norm_act


def layernorm_apply(conf, params, state, x):
    out = layernorm_norm_act(x, params["gamma"], params["beta"], conf.eps,
                             conf.activation)
    return out, state
