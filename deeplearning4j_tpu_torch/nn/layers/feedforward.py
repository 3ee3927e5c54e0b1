"""Feed-forward layers (counterpart of
`deeplearning4j_tpu/nn/layers/feedforward.py`): dense, the output
pre-activation (OutputLayer, RnnOutputLayer), the activation-only layer,
`DropoutLayer`, ids embedding, positional embedding. Dense ops act on the
last axis, so [B, F] and [B, T, F] share the code. Dense and the output
layers take input dropout or DropConnect on W at train time
(`common.py`); the embeddings draw nothing, as in the reference.

Layer signature: see `nn/layers/__init__.py`."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.common import (
    inverted_dropout,
    layer_input_dropout,
    maybe_drop_connect,
)


def dense_apply(conf, params, state, x, train=False, mask=None, rng=None):
    out, state = preoutput(conf, params, state, x, train, mask, rng)
    return activations.resolve(conf.activation)(out), state


def activation_apply(conf, params, state, x, train=False, mask=None,
                     rng=None):
    return activations.resolve(conf.activation)(x), state


def dropout_apply(conf, params, state, x, train=False, mask=None, rng=None):
    """`DropoutLayer`: inverted dropout at its retain rate, at train
    time."""
    return inverted_dropout(x, conf.dropout, rng, train), state


def preoutput(conf, params, state, x, train=False, mask=None, rng=None):
    """Linear pre-activation of an output layer (the engine applies its
    activation after the cast to the output dtype), after input dropout
    or with DropConnect on W. Mixed dtypes promote as JAX's matmul does (a
    bf16-policy ResNet reaches its output layer in f32 on the plain path:
    BatchNorm with f32 running statistics)."""
    x = layer_input_dropout(conf, x, rng, train)
    w = maybe_drop_connect(conf, params["W"], rng, train)
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    out = x @ w
    if "b" in params:
        out = out + params["b"]
    return out, state


def embedding_apply(conf, params, state, x, train=False, mask=None,
                    rng=None):
    """Embedding gather (reference `embedding_apply`, feedforward.py:42-63).
    Integer ids [B], [B, 1] or [B, T, 1]; float ids truncate toward zero,
    as the reference's int32 cast does. One-hot rows [..., n_in] are taken
    by their argmax: always under `input_format="onehot"`, and under
    "auto" for a float input whose last dim is `n_in`."""
    fmt = conf.input_format or "auto"
    onehot = (fmt == "onehot" if fmt != "auto"
              else x.is_floating_point() and x.shape[-1] == conf.n_in)
    if onehot:
        idx = torch.argmax(x, dim=-1)
    else:
        idx = x.long()
        if idx.dim() >= 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
    out = params["W"][idx]
    if "b" in params:
        out = out + params["b"]
    return activations.resolve(conf.activation)(out), state


def positional_embedding_apply(conf, params, state, x, train=False,
                               mask=None, rng=None):
    """x: [B, T, F] -> x + P[pos:pos+T].

    Stateless: always P[:T]. With `conf.stateful` the cursor rides
    undeclared state: an int (every row at one position: a fresh forward
    or `rnn_time_step`) or a [B] int32 tensor of per-slot cursors (the
    decode steppers), each row gathering its own rows, clipped to the
    table like the reference."""
    t = x.shape[1]
    if t > conf.max_length:
        raise ValueError(f"sequence length {t} exceeds "
                         f"PositionalEmbeddingLayer max_length "
                         f"{conf.max_length}")
    table = params["P"]
    if not conf.stateful:
        return x + table[:t], state
    start = state.get("pos", 0)
    if isinstance(start, torch.Tensor):
        idx = (start[:, None].long()
               + torch.arange(t, device=x.device)[None, :])
        rows = table[idx.clamp(0, conf.max_length - 1)]
    else:
        # A start past the end clamps, as the reference's dynamic_slice does.
        s = min(max(int(start), 0), conf.max_length - t)
        rows = table[s:s + t]
    return x + rows, {"pos": start + t}
