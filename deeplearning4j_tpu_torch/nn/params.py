"""Parameter initialization and checks (counterpart of
`deeplearning4j_tpu/nn/params.py`): params are `{vertex: {name: tensor}}`
with the reference's names and shapes (`W`, `b`, `P`, `gamma`, `beta`,
`Wq`, `qB`, `Wk`, `Wv`, `vB`, `Wo`, `oB`, the bottleneck's `W_a`,
`gamma_a`, ..., the recurrent layers' `W`, `RW`, `pW`, `b` and their
`_f`/`_b` pairs); the engines hold them as f32 leaf tensors that require
grad (`as_leaves`). Which of them l1/l2 reach is the layer conf's
`weight_param_keys()`. Declared layer state (the BatchNorm running stats)
starts from `init_layer_state`. `flatten_params` / `unflatten_params` are
MultiLayerNetwork's flat `params()` view: layer order, then each layer's
`param_shapes()` order, C order within a param.

A layer conf with `lora_rank` also holds its adapter leaves (`nn/lora.py`:
`W__lora_a`, `W__lora_b`, `W__lora_scale` beside each 2-D weight), drawn by
`init_layer_params` from a generator of their own, checked by
`check_params` and resolved to `W + scale * (A @ B)` by
`prep_layer_params`; the flat view leaves them out, as the reference's
does."""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import lora as lora_mod
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM,
    BatchNormalization,
    BottleneckBlock,
    ConvolutionLayer,
    GravesBidirectionalLSTM,
    GravesLSTM,
    LayerNormalization,
    MoELayer,
    VariationalAutoencoder,
    is_bias_param,
)

_LSTMS = (GravesLSTM, LSTM, GravesBidirectionalLSTM)
from deeplearning4j_tpu_torch.nn.weights import init_weights


def _fans(conf, name, shape):
    """The reference's fans (`params.py:35-52, 95-100`): an HWIO conv
    kernel has fan_in = cin*kh*kw and fan_out = cout*kh*kw (the
    bottleneck's branch kernels too); an MoE expert table [E, in, out] the
    per-expert matmul's in and out, not the stacked axis; the VAE's and
    dense weights fan_in = shape[0], fan_out = shape[1]."""
    if (isinstance(conf, ConvolutionLayer) and name == "W") or (
            isinstance(conf, BottleneckBlock) and len(shape) == 4):
        kh, kw, cin, cout = shape
        return cin * kh * kw, cout * kh * kw
    if isinstance(conf, MoELayer) and len(shape) == 3:
        return shape[1], shape[2]
    if isinstance(conf, VariationalAutoencoder):
        return shape[0], shape[1]
    if isinstance(conf, _LSTMS):
        # The reference inits the packed LSTM blocks with fans n_in (or
        # n_out for RW) and n_out, not the 4x packed width.
        return (conf.n_in if name.startswith("W") else conf.n_out,
                conf.n_out)
    if len(shape) >= 2:
        return shape[0], shape[1]
    return shape[0], shape[0]


def init_layer_params(conf, generator: torch.Generator,
                      dtype=torch.float32,
                      lora_generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
    """One layer's params from its conf (reference `init_layer_params`):
    BatchNorm gamma/beta at the conf's constants, LayerNorm gamma=1/beta=0,
    the bottleneck's gamma_* at ones, biases (beta_* included) at
    `bias_init` with an LSTM's forget block [n, 2n) at
    `forget_gate_bias_init`, peepholes at zero, weights by the layer's
    own `weight_init` (its `dist` for "distribution") and `_fans`; with
    `lora_rank`, the adapter leaves from `lora_generator` (a stream of
    their own, so adding adapters moves no base draw)."""
    params: Dict[str, torch.Tensor] = {}
    bias_init = float(conf.bias_init or 0.0)
    for name, shape in conf.param_shapes().items():
        if isinstance(conf, BatchNormalization):
            params[name] = torch.full(
                shape, conf.gamma if name == "gamma" else conf.beta,
                dtype=dtype)
        elif isinstance(conf, LayerNormalization):
            params[name] = (torch.ones(shape, dtype=dtype) if name == "gamma"
                            else torch.zeros(shape, dtype=dtype))
        elif isinstance(conf, BottleneckBlock) and name.startswith("gamma_"):
            params[name] = torch.ones(shape, dtype=dtype)
        elif is_bias_param(name):
            params[name] = torch.full(shape, bias_init, dtype=dtype)
            if isinstance(conf, _LSTMS):
                params[name][conf.n_out:2 * conf.n_out] = float(
                    conf.forget_gate_bias_init)
        elif name.startswith("pW"):
            params[name] = torch.zeros(shape, dtype=dtype)
        else:
            params[name] = init_weights(generator, shape,
                                        *_fans(conf, name, shape),
                                        scheme=conf.weight_init or "xavier",
                                        distribution=conf.dist, dtype=dtype)
    if getattr(conf, "lora_rank", None):
        if lora_generator is None:
            raise ValueError("a layer with lora_rank needs a lora_generator")
        params.update(lora_mod.init_lora_params(conf, lora_generator, dtype))
    return params


def init_layer_state(conf, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Declared state at `dtype` (reference `params.py:181-190`): every
    variance at ones, everything else (the means) at zeros."""
    return {name: (torch.ones(shape, dtype=dtype)
                   if name == "var" or name.startswith("var_")
                   else torch.zeros(shape, dtype=dtype))
            for name, shape in conf.state_shapes().items()}


def as_leaves(tree, device, dtype, grad: bool = True, frozen=None):
    """A `{vertex: {name: tensor}}` tree as the graph's own params: copies
    on `device`, floating ones at `dtype` as leaf tensors that require grad
    (the training step updates them in place, under no_grad) unless `grad`
    is False (the f32 masters) or the name is frozen (`frozen`, a
    `{vertex: names}` spec, `nn/transfer.py`). An adapter's
    `__lora_scale` stays f32 (the reference keeps it so under every
    policy)."""
    frozen = frozen or {}

    def leaf(v, k, a):
        if not a.is_floating_point():
            return a.detach().to(device, copy=True)
        dt = torch.float32 if k.endswith(lora_mod.LORA_SCALE) else dtype
        return a.detach().to(device, dt, copy=True).requires_grad_(
            grad and k not in frozen.get(v, ()))

    return {v: {k: leaf(v, k, a) for k, a in p.items()}
            for v, p in tree.items()}


def cast_floating(tree, dtype):
    """Cast every floating tensor of a `{vertex: {name: tensor}}` tree,
    leaving integer ones (ids, quantized weights) as they are."""
    return {v: {k: (a.to(dtype) if a.is_floating_point() else a)
                for k, a in p.items()}
            for v, p in tree.items()}


SCALE_SUFFIX = "__scale"


def prep_layer_params(lparams, compute_dtype, layer=None, cast=None):
    """One layer's params as its forward reads them (reference
    `prep_layer_params`): floating leaves cast to the compute dtype; an
    integer leaf with a `<name>__scale` companion (post-training int8,
    `checkpoint/quantize.py`) dequantized as `q * scale` at the compute
    dtype, the companion consumed. A weight with `__lora_a` / `__lora_b`
    siblings becomes `base + (A @ B) * scale`, each factor at the compute
    dtype, in the reference's order; the siblings are consumed
    (`__lora_scale` by the `__scale` rule). `cast`, where given, holds
    base leaves already at the compute dtype (an engine's inference copy
    of the same base), used in place of casting them again. A
    `BottleneckBlock` keeps its int8 weights and their scales as they
    are: row 12's kernel dequantizes them at the load
    (`kernels/bottleneck_block.py`)."""
    if isinstance(layer, BottleneckBlock):
        return {k: (a.to(compute_dtype) if a.is_floating_point()
                    and not k.endswith(SCALE_SUFFIX) else a)
                for k, a in lparams.items()}
    out = {}
    for k, a in lparams.items():
        if k.endswith((SCALE_SUFFIX, lora_mod.LORA_A, lora_mod.LORA_B)):
            continue
        scale = lparams.get(k + SCALE_SUFFIX)
        if cast is not None and k in cast:
            base = cast[k]
        elif scale is not None and not a.is_floating_point():
            base = a.to(compute_dtype) * scale.to(compute_dtype)
        elif a.is_floating_point():
            base = a.to(compute_dtype)
        else:
            out[k] = a
            continue
        la = lparams.get(k + lora_mod.LORA_A)
        lb = lparams.get(k + lora_mod.LORA_B)
        if la is not None and lb is not None:
            delta = la.to(compute_dtype) @ lb.to(compute_dtype)
            ls = lparams.get(k + lora_mod.LORA_SCALE)
            if ls is not None:
                delta = delta * ls.to(compute_dtype)
            base = base + delta
        out[k] = base
    return out


def prep_params(tree, compute_dtype, layers):
    """`prep_layer_params` over a `{vertex: {name: tensor}}` tree; `layers`
    maps each vertex to its conf."""
    return {v: prep_layer_params(p, compute_dtype, layers.get(v))
            for v, p in tree.items()}


def is_int8_scale(name: str) -> bool:
    """A post-training int8 weight's `__scale` companion (an adapter's
    `__lora_scale` is none)."""
    return (name.endswith(SCALE_SUFFIX)
            and not name.endswith(lora_mod.LORA_SCALE))


def quantized_leaves(tree):
    """`(vertex, name)` of every post-training int8 weight of a params
    tree (a leaf with a `__scale` companion)."""
    return [(v, k[:-len(SCALE_SUFFIX)]) for v, p in tree.items()
            for k in p if is_int8_scale(k)]


def layer_param_shapes(conf) -> Dict[str, tuple]:
    """Every leaf a layer's params hold: `param_shapes()`, then the
    adapter leaves under `lora_rank`."""
    return {**{k: tuple(s) for k, s in conf.param_shapes().items()},
            **lora_mod.lora_param_shapes(conf)}


def check_params(layers: Mapping[str, object], params: Mapping) -> None:
    """Raise unless `params` holds exactly each layer's declared names and
    shapes (with `lora_rank`, its adapter leaves too), and beside an
    integer (post-training int8) weight at most its `<name>__scale`
    companion of one value per output channel."""
    for vname, conf in layers.items():
        want = layer_param_shapes(conf)
        tree = params.get(vname, {})
        got = {k: tuple(a.shape) for k, a in tree.items()
               if not is_int8_scale(k)}
        for k, a in tree.items():
            base = tree.get(k[:-len(SCALE_SUFFIX)]) if is_int8_scale(
                k) else None
            if is_int8_scale(k) and (
                    base is None or base.is_floating_point()
                    or tuple(a.shape) != tuple(base.shape[-1:])):
                raise ValueError(f"params of vertex {vname!r}: {k!r} is no "
                                 "int8 weight's per-channel scale")
        if want != got:
            raise ValueError(f"params of vertex {vname!r}: want {want}, "
                             f"got {got}")
    extra = sorted(set(params) - set(layers))
    if extra:
        raise ValueError(f"params for unknown vertices {extra}")


def check_state(layers: Mapping[str, object], state: Mapping) -> None:
    """Raise unless `state` holds exactly each stateful layer's declared
    names and shapes (`layers`: only the layers that declare state)."""
    for vname, conf in layers.items():
        want = {k: tuple(s) for k, s in conf.state_shapes().items()}
        got = {k: tuple(a.shape) for k, a in state.get(vname, {}).items()}
        if want != got:
            raise ValueError(f"state of vertex {vname!r}: want {want}, "
                             f"got {got}")
    extra = sorted(set(state) - set(layers))
    if extra:
        raise ValueError(f"state for vertices that declare none: {extra}")


def flatten_params(params, layer_keys: List[str],
                   param_orders: Mapping[str, List[str]]) -> np.ndarray:
    """The flat 1-D view (reference `flatten_params`): layer order, then
    each layer's param order, C order within a param."""
    chunks = [params[lk][pn].detach().cpu().reshape(-1)
              for lk in layer_keys for pn in param_orders[lk]]
    if any(c.dtype == torch.bfloat16 for c in chunks):  # numpy has no bf16
        chunks = [c.float() for c in chunks]
    if not chunks:
        return np.zeros((0,), np.float32)
    return torch.cat(chunks).numpy()


def unflatten_params(flat, template, layer_keys: List[str],
                     param_orders: Mapping[str, List[str]]):
    """Inverse of `flatten_params`, shaped and typed like `template` (CPU
    tensors)."""
    flat = torch.as_tensor(np.asarray(flat))
    want = sum(template[lk][pn].numel() for lk in layer_keys
               for pn in param_orders[lk])
    if flat.numel() != want:
        raise ValueError(f"flat param length {flat.numel()} != expected "
                         f"{want}")
    out, pos = {}, 0
    for lk in layer_keys:
        out[lk] = {}
        for pn in param_orders[lk]:
            ref = template[lk][pn]
            n = ref.numel()
            out[lk][pn] = flat[pos:pos + n].reshape(ref.shape).to(ref.dtype)
            pos += n
    return out
