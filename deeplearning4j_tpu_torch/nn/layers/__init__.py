"""Layer implementation registry of the serving slice (counterpart of
`deeplearning4j_tpu/nn/layers/__init__.py`): layer-conf class name ->
`apply(conf, params, state, x) -> (out, new_state)`."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    feedforward,
    normalization,
)

LAYER_IMPLS = {
    "DenseLayer": feedforward.dense_apply,
    "RnnOutputLayer": feedforward.preoutput,
    "EmbeddingLayer": feedforward.embedding_apply,
    "PositionalEmbeddingLayer": feedforward.positional_embedding_apply,
    "LayerNormalization": normalization.layernorm_apply,
    "SelfAttentionLayer": attention.self_attention_apply,
}

# Layers whose forward emits a pre-activation (the reference's output-layer
# family); the engine applies their activation.
OUTPUT_LAYER_TYPES = {"RnnOutputLayer"}


def get_impl(conf):
    name = type(conf).__name__
    impl = LAYER_IMPLS.get(name)
    if impl is None:
        raise ValueError(f"No implementation registered for layer type "
                         f"{name}")
    return impl
