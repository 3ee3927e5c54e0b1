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

`PRETRAIN_LOSSES` are the layerwise-pretraining objectives,
`loss(conf, params, x, key)`, of the pretrainable layers (VAE,
AutoEncoder, RBM; `MultiLayerNetwork.pretrain`).

`check_supported` is what an engine asks of each layer when it is
constructed: a base conf with no forward pass, or a LoRA adapter, raises
NotImplementedError, the adapter naming its ROADMAP item."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    bottleneck,
    convolution,
    feedforward,
    moe,
    normalization,
    pooling,
    recurrent,
    variational,
)

LAYER_IMPLS = {
    "DenseLayer": feedforward.dense_apply,
    "OutputLayer": feedforward.preoutput,
    "RnnOutputLayer": feedforward.preoutput,
    "CenterLossOutputLayer": feedforward.preoutput,
    "LossLayer": feedforward.loss_layer_apply,
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
    "AutoEncoder": feedforward.autoencoder_apply,
    "RBM": feedforward.rbm_apply,
    "MoELayer": moe.moe_apply,
    "VariationalAutoencoder": variational.vae_apply,
}

# Layers whose forward emits a pre-activation (the reference's output-layer
# family); the engine applies their activation.
OUTPUT_LAYER_TYPES = {"OutputLayer", "RnnOutputLayer", "LossLayer",
                      "CenterLossOutputLayer"}

# Layerwise pretraining objectives (reference `PRETRAIN_LOSSES`).
PRETRAIN_LOSSES = {
    "VariationalAutoencoder": variational.vae_pretrain_loss,
    "AutoEncoder": feedforward.autoencoder_pretrain_loss,
    "RBM": feedforward.rbm_pretrain_loss,
}


# Layers that consume the features mask (`mask_after`).
MASK_CONSUMERS = {"GlobalPoolingLayer"}


def check_supported(key: str, conf) -> None:
    """Raise NotImplementedError for a layer the port cannot run (a LoRA
    adapter naming its ROADMAP item)."""
    kind = type(conf).__name__
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
