"""Feed-forward layers (counterpart of
`deeplearning4j_tpu/nn/layers/feedforward.py`): dense, the output
pre-activation (OutputLayer, RnnOutputLayer, CenterLossOutputLayer), the
activation-only layer, `DropoutLayer`, ids embedding, positional
embedding, and the pretrainable AutoEncoder and RBM (their supervised
forwards and their layerwise-pretraining losses). Dense ops act on the
last axis, so [B, F] and [B, T, F] share the code. Dense, the output
layers and the AutoEncoder take input dropout or DropConnect on W at train
time (`common.py`); the embeddings and the RBM draw nothing there, as in
the reference. The AutoEncoder's corruption and the RBM's Gibbs samples
are `common.draw_bernoulli` draws from the reference's keys.

Layer signature: see `nn/layers/__init__.py`."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers import common
from deeplearning4j_tpu_torch.nn.layers.common import (
    inverted_dropout,
    layer_input_dropout,
    maybe_drop_connect,
)
from deeplearning4j_tpu_torch.nn.prng import fold_in


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


def loss_layer_apply(conf, params, state, x, train=False, mask=None,
                     rng=None):
    """`LossLayer`: its input is the pre-activation (no params)."""
    return x, state


def autoencoder_apply(conf, params, state, x, train=False, mask=None,
                      rng=None):
    """The supervised forward: encode, as a dense layer."""
    return dense_apply(conf, params, state, x, train, mask, rng)


def autoencoder_reconstruct(conf, params, x, key=None, corrupt=False):
    """Encode and decode with tied weights, after masking-noise corruption
    when `corrupt` (each input kept with probability 1 - corruption_level,
    else zeroed)."""
    act = activations.resolve(conf.activation)
    if corrupt and key is not None and conf.corruption_level > 0:
        keep = common.draw_bernoulli(key, 1.0 - conf.corruption_level,
                                     x.shape, x.device)
        x = torch.where(keep, x, 0.0)
    y = act(x @ params["W"] + params["b"])
    return act(y @ params["W"].T + params["vb"])


def autoencoder_pretrain_loss(conf, params, x, key):
    """The denoising reconstruction loss: the conf's loss (default
    reconstruction cross-entropy) of the input against the decoded
    corrupted input, which is already post-activation."""
    from deeplearning4j_tpu_torch.nn import losses

    z = autoencoder_reconstruct(conf, params, x, key=key, corrupt=True)
    return losses.score(conf.loss_function, x, z, "identity")


def rbm_apply(conf, params, state, x, train=False, mask=None, rng=None):
    """The supervised forward, propUp: the hidden units' mean (binary:
    sigmoid; gaussian: the pre-activation; rectified: relu; softmax)."""
    pre = x @ params["W"] + params["b"]
    out = {"gaussian": lambda p: p, "rectified": torch.relu,
           "softmax": lambda p: torch.softmax(p, dim=-1)}.get(
        conf.hidden_unit, torch.sigmoid)(pre)
    return out, state


def _rbm_free_energy(conf, params, v):
    """F(v) = -v.vb - sum softplus(vW + b) (binary hidden units)."""
    wx_b = v @ params["W"] + params["b"]
    return -(v @ params["vb"]) - torch.nn.functional.softplus(wx_b).sum(-1)


def rbm_pretrain_loss(conf, params, x, key):
    """CD-k as a differentiable surrogate: Gibbs-sample v_k over k steps
    (step j's hidden draw from `fold_in(key, 2j)`, its visible draw from
    `fold_in(key, 2j + 1)`), then mean F(v) - mean F(v_k) with v_k
    detached; its gradient is the CD-k gradient."""
    words = common.key_words(key)
    with torch.no_grad():
        vk = x
        for step in range(max(1, conf.k)):
            p = torch.sigmoid(vk @ params["W"] + params["b"])
            h = (common.draw_bernoulli(fold_in(words, 2 * step), p, p.shape,
                                       p.device).to(vk.dtype)
                 if conf.hidden_unit == "binary" else p)
            pre = h @ params["W"].T + params["vb"]
            kv = fold_in(words, 2 * step + 1)
            if conf.visible_unit == "gaussian":
                vk = pre + common.draw_normal(kv, pre.shape, pre.dtype,
                                              pre.device)
            else:
                p = torch.sigmoid(pre)
                vk = (common.draw_bernoulli(kv, p, p.shape,
                                            p.device).to(x.dtype)
                      if conf.visible_unit == "binary" else p)
    return (_rbm_free_energy(conf, params, x).mean()
            - _rbm_free_energy(conf, params, vk).mean())
