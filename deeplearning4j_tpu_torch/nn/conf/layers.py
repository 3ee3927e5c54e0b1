"""Layer configurations (counterpart of `deeplearning4j_tpu/nn/conf/layers.py`):
the seven confs `transformer_lm` uses, with the reference's field names
(the training fields of `layers.py:82-100` included), defaults and
`param_shapes()` order, so `from_dict` reads the reference's `to_json()` as
it is."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def layer_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("@class")
    cls = _LAYER_REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"layer type {kind} is not in the port; it has "
                         f"{sorted(_LAYER_REGISTRY)}")
    return cls.from_dict(d)


def is_bias_param(name: str) -> bool:
    """Bias-vs-weight classification of the reference (`nn/conf/layers.py`)."""
    return (name in ("b", "vb", "beta")
            or name.startswith(("b_", "eb", "db", "beta_"))
            or name.endswith("B"))


@dataclass
class Layer:
    """Base conf: per-layer overrides of the global fields (None = inherit
    the global value), the reference's names and meanings. `dropout` is a
    retain probability (0, 1 and None disable it)."""

    name: Optional[str] = None
    activation: Any = None
    weight_init: Any = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    use_drop_connect: Optional[bool] = None
    bias_init: Optional[float] = None
    updater: Any = None
    momentum: Optional[float] = None
    adam_mean_decay: Optional[float] = None
    adam_var_decay: Optional[float] = None
    rho: Optional[float] = None
    rms_decay: Optional[float] = None
    epsilon: Optional[float] = None
    gradient_normalization: Any = None
    gradient_normalization_threshold: Optional[float] = None
    frozen: Optional[bool] = None

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def weight_param_keys(self):
        """Params regularized by l1/l2 (biases never are)."""
        return [k for k in self.param_shapes() if not is_bias_param(k)]

    def state_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    @classmethod
    def from_dict(cls, d: dict):
        if d.get("lora_rank"):
            raise ValueError("LoRA adapters are not in the port yet")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class FeedForwardLayer(Layer):
    n_in: int = 0
    n_out: int = 0

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}


@register_layer
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer."""


@register_layer
@dataclass
class RnnOutputLayer(FeedForwardLayer):
    """Per-timestep output layer: its forward is the linear pre-activation;
    the engine applies `activation` after the cast to the output dtype."""

    loss_function: Any = "mcxent"


@register_layer
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> vector lookup. The port reads `input_format="ids"` (what
    the transformer zoo pins)."""

    has_bias: bool = True
    input_format: str = "auto"

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes


@register_layer
@dataclass
class LayerNormalization(FeedForwardLayer):
    """Per-example layer norm over the feature axis."""

    eps: float = 1e-5
    activation: Any = "identity"

    def param_shapes(self):
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}


@register_layer
@dataclass
class PositionalEmbeddingLayer(FeedForwardLayer):
    """Learned position table; `stateful` keeps a position cursor in the
    layer's undeclared state for stateful decode."""

    max_length: int = 512
    stateful: bool = False
    activation: Any = "identity"

    def param_shapes(self):
        return {"P": (self.max_length, self.n_out)}


@register_layer
@dataclass
class SelfAttentionLayer(FeedForwardLayer):
    """Multi-head self-attention; `decode_cache_length` sizes the KV cache
    of stateful decode."""

    n_heads: int = 4
    causal: bool = True
    attention_impl: str = "auto"
    decode_cache_length: Optional[int] = None
    activation: Any = "identity"

    def param_shapes(self):
        # No key bias (reference: softmax is invariant to it).
        return {
            "Wq": (self.n_in, self.n_out), "qB": (self.n_out,),
            "Wk": (self.n_in, self.n_out),
            "Wv": (self.n_in, self.n_out), "vB": (self.n_out,),
            "Wo": (self.n_out, self.n_out), "oB": (self.n_out,),
        }
