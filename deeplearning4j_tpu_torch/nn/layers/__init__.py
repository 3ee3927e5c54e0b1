"""Layer implementation registry (counterpart of
`deeplearning4j_tpu/nn/layers/__init__.py`): layer-conf class name ->
`apply(conf, params, state, x, train=False, mask=None) -> (out,
new_state)`, `mask` a [B, T] step mask that only the recurrent layers
read."""

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
    "EmbeddingLayer": feedforward.embedding_apply,
    "PositionalEmbeddingLayer": feedforward.positional_embedding_apply,
    "LayerNormalization": normalization.layernorm_apply,
    "BatchNormalization": normalization.batchnorm_apply,
    "SelfAttentionLayer": attention.self_attention_apply,
    "ConvolutionLayer": convolution.conv2d_apply,
    "SubsamplingLayer": convolution.subsampling_apply,
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


def get_impl(conf):
    name = type(conf).__name__
    impl = LAYER_IMPLS.get(name)
    if impl is None:
        raise ValueError(f"No implementation registered for layer type "
                         f"{name}")
    return impl
