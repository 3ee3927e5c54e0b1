"""Recurrent layers: GravesLSTM, LSTM, bidirectional, SimpleRnn
(counterpart of `deeplearning4j_tpu/nn/layers/recurrent.py`).

Semantics as the reference's: gate order i, f, o, g in the packed weights;
Graves peepholes (i and f see c_{t-1}, o sees c_t; `pW` = [p_i, p_f, p_o]);
at a masked step the state carries through and the output is zeroed; the
bidirectional output is the forward plus the backward pass. x is
[batch, time, features].

The input projection `x @ W + b` is one matmul over all steps
(`torch.matmul`, outside the kernel, as it lies outside the Pallas kernel
in the JAX package); then a Python loop over time calls the cell
(`kernels/lstm_cell.py`: the CUDA kernel on the card, one launch per step)
where the JAX package runs `lax.scan`. A step mask is cast to x's dtype,
as the Pallas cell takes it, so the carry keeps x's dtype.

At train time each layer takes input dropout, or DropConnect on its input
weights W only, never on RW or pW (reference recurrent.py:82-89, 106-109;
`common.py`); W enters only through `x @ W` before the loop, so the cell
kernel's inputs do not change. The bidirectional layer splits its key
between the two directions' W.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import lstm_cell as _cell
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.common import (
    layer_input_dropout,
    maybe_drop_connect,
)


def _lstm_scan(conf, params, x, mask, h0, c0, peephole: bool,
               reverse: bool = False, suffix: str = ""):
    """An LSTM over [b, t, f]; returns (outputs [b, t, n_out], (hT, cT))."""
    W, RW, b = (params[k + suffix] for k in ("W", "RW", "b"))
    pW = params["pW" + suffix] if peephole else None
    xw = x @ W + b  # [b, t, 4 n_out], every step at once
    xs = xw.unbind(1)  # unbind's backward stacks: one copy, not t
    ms = mask.to(x.dtype).unbind(1) if mask is not None else None
    steps = range(len(xs) - 1, -1, -1) if reverse else range(len(xs))
    h, c, outs = h0, c0, [None] * len(xs)
    for s in steps:
        h, c, outs[s] = _cell.lstm_cell(
            xs[s], h, c, RW, pW, None if ms is None else ms[s],
            conf.gate_activation, conf.activation)
    return torch.stack(outs, 1), (h, c)


def _zeros_state(x, n_out):
    return (torch.zeros(x.shape[0], n_out, dtype=x.dtype, device=x.device),
            torch.zeros(x.shape[0], n_out, dtype=x.dtype, device=x.device))


def lstm_apply(conf, params, state, x, train=False, mask=None, rng=None,
               peephole=True):
    """GravesLSTM / LSTM forward. `state` holding h and c seeds the scan
    (`rnn_time_step` and the chunks of truncated BPTT); the new h and c
    come back as the layer's undeclared state."""
    x = layer_input_dropout(conf, x, rng, train)
    params = {**params, "W": maybe_drop_connect(conf, params["W"], rng,
                                                train)}
    if state and "h" in state:
        h0, c0 = state["h"], state["c"]
    else:
        h0, c0 = _zeros_state(x, conf.n_out)
    outs, (hT, cT) = _lstm_scan(conf, params, x, mask, h0, c0, peephole)
    return outs, {"h": hT, "c": cT}


def graves_lstm_apply(conf, params, state, x, train=False, mask=None,
                      rng=None):
    return lstm_apply(conf, params, state, x, train, mask, rng,
                      peephole=True)


def standard_lstm_apply(conf, params, state, x, train=False, mask=None,
                        rng=None):
    return lstm_apply(conf, params, state, x, train, mask, rng,
                      peephole=False)


def bidirectional_lstm_apply(conf, params, state, x, train=False, mask=None,
                             rng=None):
    """Both directions from zero state (no carried state, as in the
    reference); the output is their sum."""
    x = layer_input_dropout(conf, x, rng, train)
    if rng is not None and conf.use_drop_connect:
        r_f, r_b = rng.split()
        params = {**params,
                  "W_f": maybe_drop_connect(conf, params["W_f"], r_f, train),
                  "W_b": maybe_drop_connect(conf, params["W_b"], r_b, train)}
    h0, c0 = _zeros_state(x, conf.n_out)
    fwd, _ = _lstm_scan(conf, params, x, mask, h0, c0, True, suffix="_f")
    bwd, _ = _lstm_scan(conf, params, x, mask, h0, c0, True, reverse=True,
                        suffix="_b")
    return fwd + bwd, state


def simple_rnn_apply(conf, params, state, x, train=False, mask=None,
                     rng=None):
    """h_t = act(x_t W + b + h_{t-1} RW), masked steps carrying h; plain
    PyTorch (the JAX package has no kernel for it)."""
    x = layer_input_dropout(conf, x, rng, train)
    act = activations.resolve(conf.activation)
    if state and "h" in state:
        h = state["h"]
    else:
        h = torch.zeros(x.shape[0], conf.n_out, dtype=x.dtype,
                        device=x.device)
    xw = x @ maybe_drop_connect(conf, params["W"], rng, train) + params["b"]
    ms = mask.to(x.dtype).unbind(1) if mask is not None else None
    outs = []
    for s, xw_t in enumerate(xw.unbind(1)):
        h_new = act(xw_t + h @ params["RW"])
        if ms is not None:
            m = ms[s][:, None]
            h_new = m * h_new + (1.0 - m) * h
        h = h_new
        outs.append(h)
    outs = torch.stack(outs, 1)
    if mask is not None:
        outs = outs * mask.to(x.dtype)[..., None]
    return outs, {"h": h}
