"""Layer implementation registry (counterpart of
`deeplearning4j_tpu/nn/layers/__init__.py`): layer-conf class name ->
`apply(conf, params, state, x, train=False, mask=None, rng=None) -> (out,
new_state)`. `mask` is a [B, T] features mask, read by the recurrent
layers, attention and global pooling; `rng` the layer's `LayerKey`
(`nn/prng.py`) in a train-mode forward, else None.

The reference's layers return `(out, state, out_mask)`; here the rule for
the mask a layer hands on is one function both engines call,
`mask_after`: global pooling consumes it, every other layer passes it
through.

`check_supported` is what an engine asks of each layer when it is
constructed: a layer the port holds as a conf only, or a LoRA adapter,
raises NotImplementedError naming its ROADMAP item."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    bottleneck,
    convolution,
    feedforward,
    normalization,
    pooling,
    recurrent,
)

LAYER_IMPLS = {
    "DenseLayer": feedforward.dense_apply,
    "OutputLayer": feedforward.preoutput,
    "RnnOutputLayer": feedforward.preoutput,
    "ActivationLayer": feedforward.activation_apply,
    "DropoutLayer": feedforward.dropout_apply,
    "EmbeddingLayer": feedforward.embedding_apply,
    "PositionalEmbeddingLayer": feedforward.positional_embedding_apply,
    "LayerNormalization": normalization.layernorm_apply,
    "BatchNormalization": normalization.batchnorm_apply,
    "SelfAttentionLayer": attention.self_attention_apply,
    "ConvolutionLayer": convolution.conv2d_apply,
    "SubsamplingLayer": convolution.subsampling_apply,
    "LocalResponseNormalization": convolution.lrn_apply,
    "GlobalPoolingLayer": pooling.global_pooling_apply,
    "BottleneckBlock": bottleneck.bottleneck_apply,
    "GravesLSTM": recurrent.graves_lstm_apply,
    "LSTM": recurrent.standard_lstm_apply,
    "GravesBidirectionalLSTM": recurrent.bidirectional_lstm_apply,
    "SimpleRnn": recurrent.simple_rnn_apply,
}

# Layers whose forward emits a pre-activation (the reference's output-layer
# family); the engine applies their activation.
OUTPUT_LAYER_TYPES = {"OutputLayer", "RnnOutputLayer"}


# Layers that consume the features mask (`mask_after`).
MASK_CONSUMERS = {"GlobalPoolingLayer"}

# Layer confs whose forward pass is still to port, by ROADMAP item.
CONF_ONLY = {
    "MoELayer": "A.9", "VariationalAutoencoder": "A.9", "RBM": "A.9",
    "AutoEncoder": "A.9", "CenterLossOutputLayer": "A.9", "LossLayer": "A.9",
}


def check_supported(key: str, conf) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a layer the
    port cannot run yet."""
    kind = type(conf).__name__
    if kind in CONF_ONLY:
        raise NotImplementedError(
            f"layer {key!r} ({kind}): its forward pass is not in the port "
            f"yet (ROADMAP {CONF_ONLY[kind]})")
    if kind not in LAYER_IMPLS:
        # BaseOutputLayer, BaseRecurrentLayer: bases that no engine of
        # either package runs.
        raise NotImplementedError(
            f"layer {key!r} ({kind}) is a base conf with no forward pass")
    if getattr(conf, "lora_rank", None):
        raise NotImplementedError(
            f"layer {key!r}: LoRA adapters (lora_rank={conf.lora_rank}) are "
            "not in the port yet (ROADMAP A.12)")


def get_impl(conf):
    return LAYER_IMPLS[type(conf).__name__]


def mask_after(conf, mask):
    """The features mask a layer hands to the next one."""
    return None if type(conf).__name__ in MASK_CONSUMERS else mask
