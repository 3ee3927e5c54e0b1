"""Layer implementation registry (counterpart of
`deeplearning4j_tpu/nn/layers/__init__.py`): layer-conf class name ->
`apply(conf, params, state, x, train=False) -> (out, new_state)`."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    bottleneck,
    convolution,
    feedforward,
    normalization,
    pooling,
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
