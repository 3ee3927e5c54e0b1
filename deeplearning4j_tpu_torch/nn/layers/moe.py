"""The mixture-of-experts layer (counterpart of
`deeplearning4j_tpu/nn/layers/moe.py`): `MoELayer` over
`parallel/expert.py`'s routed FFN, on one device.

The layer's key splits into a dropout key and a jitter key (the
reference's `split(rng)`), so the two draws never share bits; input
dropout, then the leading dims flattened into tokens, the FFN (jitter in
training only), the conf's activation. The returned state carries
`_aux_loss`, the layer's `aux_loss_weight` times its load-balance loss:
the engines take it into the training objective and never keep it as
state. Expert parallelism (an expert mesh axis) needs several cards
(ROADMAP A.13)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.common import layer_input_dropout
from deeplearning4j_tpu_torch.parallel import expert


def moe_apply(conf, params, state, x, train=False, mask=None, rng=None):
    """x [B, n_in] or [B, T, n_in] -> the same leading shape by n_out."""
    drop_rng = jitter_rng = None
    if rng is not None:
        drop_rng, jitter_rng = rng.split()
    x = layer_input_dropout(conf, x, drop_rng, train)
    lead = x.shape[:-1]
    y, aux = expert.moe_ffn(
        {"gate_w": params["gate_w"], "w1": params["w1"],
         "b1": params["b_1"], "w2": params["w2"], "b2": params["b_2"]},
        x.reshape(-1, x.shape[-1]), capacity_factor=conf.capacity_factor,
        top_k=conf.top_k, rng=jitter_rng if train else None,
        jitter_eps=conf.router_jitter, return_aux=True)
    out = activations.resolve(conf.activation)(y.reshape(*lead, conf.n_out))
    return out, {**state, "_aux_loss": conf.aux_loss_weight * aux}
