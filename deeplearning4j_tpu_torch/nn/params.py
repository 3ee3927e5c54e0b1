"""Parameter initialization and checks (counterpart of
`deeplearning4j_tpu/nn/params.py`): params are `{vertex: {name: tensor}}`
with the reference's names and shapes (`W`, `b`, `P`, `gamma`, `beta`,
`Wq`, `qB`, `Wk`, `Wv`, `vB`, `Wo`, `oB`); the graph holds them as f32
leaf tensors that require grad (`as_leaves`). Which of them l1/l2 reach is
the layer conf's `weight_param_keys()`."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerNormalization,
    is_bias_param,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _fans(shape):
    if len(shape) >= 2:
        return shape[0], shape[1]
    return shape[0], shape[0]


def init_layer_params(conf, generator: torch.Generator,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """One layer's params from its conf: LayerNorm gamma=1/beta=0, biases
    at `bias_init`, weights by the conf's scheme (fans as the reference's
    dense convention: fan_in = shape[0], fan_out = shape[1])."""
    params: Dict[str, torch.Tensor] = {}
    bias_init = float(conf.bias_init or 0.0)
    for name, shape in conf.param_shapes().items():
        if isinstance(conf, LayerNormalization):
            params[name] = (torch.ones(shape, dtype=dtype) if name == "gamma"
                            else torch.zeros(shape, dtype=dtype))
        elif is_bias_param(name):
            params[name] = torch.full(shape, bias_init, dtype=dtype)
        else:
            params[name] = init_weights(generator, shape, *_fans(shape),
                                        scheme=conf.weight_init or "xavier",
                                        dtype=dtype)
    return params


def as_leaves(tree, device, dtype):
    """A `{vertex: {name: tensor}}` tree as the graph's own params: copies
    on `device`, floating ones at `dtype` as leaf tensors that require grad
    (the training step updates them in place, under no_grad)."""
    return {v: {k: (a.detach().to(device, dtype, copy=True)
                    .requires_grad_(True) if a.is_floating_point()
                    else a.detach().to(device, copy=True))
                for k, a in p.items()}
            for v, p in tree.items()}


def cast_floating(tree, dtype):
    """Cast every floating tensor of a `{vertex: {name: tensor}}` tree."""
    return {v: {k: (a.to(dtype) if a.is_floating_point() else a)
                for k, a in p.items()}
            for v, p in tree.items()}


def check_params(layers: Mapping[str, object], params: Mapping) -> None:
    """Raise unless `params` holds exactly each layer's declared names and
    shapes."""
    for vname, conf in layers.items():
        want = {k: tuple(s) for k, s in conf.param_shapes().items()}
        got = {k: tuple(a.shape) for k, a in params.get(vname, {}).items()}
        if want != got:
            raise ValueError(f"params of vertex {vname!r}: want {want}, "
                             f"got {got}")
    extra = sorted(set(params) - set(layers))
    if extra:
        raise ValueError(f"params for unknown vertices {extra}")
