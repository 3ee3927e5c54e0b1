"""Feed-forward layers of the serving slice (counterpart of
`deeplearning4j_tpu/nn/layers/feedforward.py`): dense, the output
pre-activation, ids embedding, positional embedding. Dense ops act on the
last axis, so [B, F] and [B, T, F] share the code.

Layer signature: `apply(conf, params, state, x) -> (out, new_state)`."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations


def dense_apply(conf, params, state, x):
    out, state = preoutput(conf, params, state, x)
    return activations.resolve(conf.activation)(out), state


def preoutput(conf, params, state, x):
    """Linear pre-activation of an output layer (the engine applies its
    activation after the cast to the output dtype)."""
    out = x @ params["W"]
    if "b" in params:
        out = out + params["b"]
    return out, state


def embedding_apply(conf, params, state, x):
    """Embedding gather over integer ids [B], [B, 1] or [B, T, 1]. Float ids
    truncate toward zero, as the reference's int32 cast does."""
    if conf.input_format != "ids":
        raise ValueError(f"EmbeddingLayer input_format "
                         f"{conf.input_format!r} is not in the port (it "
                         "reads 'ids')")
    idx = x.long()
    if idx.dim() >= 2 and idx.shape[-1] == 1:
        idx = idx[..., 0]
    out = params["W"][idx]
    if "b" in params:
        out = out + params["b"]
    return activations.resolve(conf.activation)(out), state


def positional_embedding_apply(conf, params, state, x):
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
