"""Layer configurations (counterpart of `deeplearning4j_tpu/nn/conf/layers.py`):
every layer conf of the reference, with its field names, defaults,
`param_shapes()` and `state_shapes()` order. `to_dict` writes what the
reference writes (no None fields, tuples as lists, `@class`), and
`from_dict` reads it back keeping every key: a key the class does not have
raises ValueError naming it. `set_n_in`, `get_output_type` and
`default_preprocessor` are the builders' shape inference (the reference's
`layers.py:112-120, 179-199, 361-375, 402-411`): feed-forward, recurrent
and convolutional input types, output sizes under TRUNCATE, STRICT and
SAME, and the preprocessor a layer asks for between layer families.

Seven confs are confs only here: `BaseOutputLayer`, `LossLayer`,
`CenterLossOutputLayer`, `MoELayer`, `AutoEncoder`, `RBM` and
`VariationalAutoencoder` build, size and serialize, and a network that
holds one is refused at construction (`nn/layers/__init__.py`
`check_supported`)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.nn.conf.distributions import Distribution
from deeplearning4j_tpu_torch.nn.conf.enums import ConvolutionMode, plain
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor,
    CnnToRnnPreProcessor,
    FeedForwardToCnnPreProcessor,
    FeedForwardToRnnPreProcessor,
    InputPreProcessor,
)

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


def _tuple2(v) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(a) for a in v)
    return (t[0], t[0]) if len(t) == 1 else t


# Fields the reference keeps as tuples; JSON brings them back as lists.
_TUPLE_FIELDS = ("kernel_size", "stride", "padding", "dilation",
                 "pooling_dimensions", "encoder_layer_sizes",
                 "decoder_layer_sizes")


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
    dist: Optional[Distribution] = None
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
    # Transfer learning and LoRA (`nn/transfer.py`, `nn/lora.py`): a
    # frozen layer's params do not train; `lora_rank` adds adapter leaves
    # beside every 2-D weight, whose base then freezes.
    frozen: Optional[bool] = None
    lora_rank: Optional[int] = None
    lora_alpha: Optional[float] = None

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def set_n_in(self, input_type: InputType, override: bool) -> None:
        """Infer n_in from the previous layer's output type (no-op here)."""

    def default_preprocessor(
            self, input_type: InputType) -> Optional[InputPreProcessor]:
        """The reference's automatic preprocessor for this input (None: the
        input fits as it is)."""
        return None

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def weight_param_keys(self):
        """Params regularized by l1/l2 (biases never are)."""
        return [k for k in self.param_shapes() if not is_bias_param(k)]

    def state_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"@class": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, Distribution):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            d[f.name] = plain(v)
        return d

    @classmethod
    def from_dict(cls, d: dict):
        kwargs = dict(d)
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(kwargs) - names)
        if unknown:
            raise ValueError(f"{cls.__name__} has no fields {unknown}")
        if isinstance(kwargs.get("dist"), dict):
            kwargs["dist"] = Distribution.from_dict(kwargs["dist"])
        for key in _TUPLE_FIELDS:
            if isinstance(kwargs.get(key), list):
                kwargs[key] = tuple(kwargs[key])
        return cls(**kwargs)


@dataclass
class FeedForwardLayer(Layer):
    n_in: int = 0
    n_out: int = 0

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out,
                                       input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def set_n_in(self, input_type: InputType, override: bool) -> None:
        if override or not self.n_in:
            self.n_in = input_type.flat_size()

    def default_preprocessor(self, input_type: InputType):
        if input_type.kind == "cnn":
            return CnnToFeedForwardPreProcessor(
                input_type.height, input_type.width, input_type.channels)
        return None

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}


def conv_out_hw(layer, h: int, w: int) -> Tuple[int, int]:
    """A convolution's or pooling's output size: ceil(n / s) under SAME;
    (n + 2p - k) // s + 1 under TRUNCATE, and under STRICT only where that
    division is exact."""
    mode = (ConvolutionMode.of(layer.convolution_mode)
            or ConvolutionMode.TRUNCATE)
    (kh, kw), (sh, sw), (ph, pw) = (layer.kernel_size, layer.stride,
                                    layer.padding)
    if mode == ConvolutionMode.SAME:
        return -(-h // sh), -(-w // sw)
    if mode == ConvolutionMode.STRICT and (
            (h + 2 * ph - kh) % sh or (w + 2 * pw - kw) % sw):
        raise ValueError(
            f"ConvolutionMode.STRICT: input {h}x{w} with kernel "
            f"{layer.kernel_size}, stride {layer.stride}, padding "
            f"{layer.padding} does not tile exactly (use TRUNCATE or SAME)")
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def _same_size(layer, input_type: InputType) -> InputType:
    return input_type


def _set_n_in_flat(layer, input_type: InputType, override: bool) -> None:
    layer.n_in = layer.n_out = input_type.flat_size()


@register_layer
@dataclass
class BaseRecurrentLayer(FeedForwardLayer):
    """Recurrent layers: [b, t, n_in] -> [b, t, n_out]; a feed-forward or
    convolutional input gets the reference's FeedForwardToRnn or CnnToRnn
    preprocessor."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def default_preprocessor(self, input_type: InputType):
        if input_type.kind == "ff":
            return FeedForwardToRnnPreProcessor()
        if input_type.kind == "cnn":
            return CnnToRnnPreProcessor(input_type.height, input_type.width,
                                        input_type.channels)
        return None


@register_layer
@dataclass
class DenseLayer(FeedForwardLayer):
    """Fully-connected layer."""


@register_layer
@dataclass
class BaseOutputLayer(FeedForwardLayer):
    """Dense + loss: the output layers' base, a conf of its own in the
    reference."""

    loss_function: Any = "mcxent"

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["loss_function"] = str(plain(self.loss_function))
        return d


@register_layer
@dataclass
class RnnOutputLayer(BaseOutputLayer):
    """Per-timestep output layer: its forward is the linear pre-activation;
    the engine applies `activation` after the cast to the output dtype."""

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def default_preprocessor(self, input_type: InputType):
        if input_type.kind == "ff":
            return FeedForwardToRnnPreProcessor()
        return None


@register_layer
@dataclass
class OutputLayer(BaseOutputLayer):
    """Dense + loss output layer: its forward is the linear pre-activation;
    the engine applies `activation` after the cast to the output dtype."""


@register_layer
@dataclass
class LossLayer(BaseOutputLayer):
    """Loss only, no params."""

    get_output_type = _same_size
    set_n_in = _set_n_in_flat

    def param_shapes(self):
        return {}


@register_layer
@dataclass
class CenterLossOutputLayer(BaseOutputLayer):
    """Output layer with center loss: per-class feature centers as state,
    moved at rate `alpha`; `lambda_` weighs the center term."""

    alpha: float = 0.05
    lambda_: float = 2e-4

    def state_shapes(self):
        return {"centers": (self.n_out, self.n_in)}


@register_layer
@dataclass
class DropoutLayer(FeedForwardLayer):
    """Dropout only, no params."""

    get_output_type = _same_size
    set_n_in = _set_n_in_flat

    def param_shapes(self):
        return {}


@register_layer
@dataclass
class EmbeddingLayer(FeedForwardLayer):
    """Index -> vector lookup. `input_format`: "ids", "onehot" (taken by
    argmax), or "auto" (one-hot for a float input whose last dim is
    `n_in`, else ids), as the reference reads them."""

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

    get_output_type = _same_size
    set_n_in = _set_n_in_flat

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

    get_output_type = _same_size
    set_n_in = _set_n_in_flat

    def param_shapes(self):
        return {"P": (self.max_length, self.n_out)}


@register_layer
@dataclass
class SelfAttentionLayer(BaseRecurrentLayer):
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


@register_layer
@dataclass
class ActivationLayer(Layer):
    """Activation-only layer; n_in = n_out = the input's flat size."""

    n_in: int = 0
    n_out: int = 0

    set_n_in = _set_n_in_flat


@register_layer
@dataclass
class ConvolutionLayer(FeedForwardLayer):
    """2-D convolution: n_in input channels, n_out filters; the kernel is
    HWIO `[kh, kw, in, out]`, activations NHWC."""

    kernel_size: Tuple[int, int] = (5, 5)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: Optional[Any] = None  # None: TRUNCATE
    dilation: Tuple[int, int] = (1, 1)
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = _tuple2(self.kernel_size)
        self.stride = _tuple2(self.stride)
        self.padding = _tuple2(self.padding)
        self.dilation = _tuple2(self.dilation)

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(
            *conv_out_hw(self, input_type.height, input_type.width),
            self.n_out)

    def set_n_in(self, input_type: InputType, override: bool) -> None:
        if override or not self.n_in:
            self.n_in = input_type.channels

    def default_preprocessor(self, input_type: InputType):
        if input_type.kind == "cnnflat":
            return FeedForwardToCnnPreProcessor(
                input_type.height, input_type.width, input_type.channels)
        return None

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes


@register_layer
@dataclass
class SubsamplingLayer(Layer):
    """Spatial pooling, no params."""

    pooling_type: Any = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: Optional[Any] = None
    pnorm: int = 2

    def __post_init__(self):
        self.kernel_size = _tuple2(self.kernel_size)
        self.stride = _tuple2(self.stride)
        self.padding = _tuple2(self.padding)

    def get_output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(
            *conv_out_hw(self, input_type.height, input_type.width),
            input_type.channels)


@register_layer
@dataclass
class BatchNormalization(FeedForwardLayer):
    """Batch normalization (decay 0.9, eps 1e-5, minibatch statistics in
    training, optional locked gamma/beta constants); running mean and var
    are declared state."""

    decay: float = 0.9
    eps: float = 1e-5
    is_minibatch: bool = True
    lock_gamma_beta: bool = False
    gamma: float = 1.0
    beta: float = 0.0

    get_output_type = _same_size

    def set_n_in(self, input_type: InputType, override: bool) -> None:
        if override or not self.n_out:
            self.n_in = self.n_out = (
                input_type.flat_size() if input_type.kind in ("ff", "rnn")
                else input_type.channels)

    def default_preprocessor(self, input_type: InputType):
        return None

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def state_shapes(self):
        return {"mean": (self.n_out,), "var": (self.n_out,)}


@register_layer
@dataclass
class BottleneckBlock(FeedForwardLayer):
    """The ResNet bottleneck as one layer: conv1x1 (stride) -> BN+act ->
    conv3x3 SAME -> BN+act -> conv1x1 -> BN, plus the input or a projected
    (conv1x1 stride + BN) shortcut, then act. `filters` is the squeeze
    width; the output has `4 * filters` channels."""

    filters: int = 64
    stride: Tuple[int, int] = (1, 1)
    project: bool = False
    decay: float = 0.9
    eps: float = 1e-5
    is_minibatch: bool = True

    def __post_init__(self):
        self.stride = _tuple2(self.stride)

    def branch_names(self) -> Tuple[str, ...]:
        return ("a", "b", "c") + (("proj",) if self.project else ())

    def get_output_type(self, input_type: InputType) -> InputType:
        sh, sw = self.stride
        return InputType.convolutional(-(-input_type.height // sh),
                                       -(-input_type.width // sw),
                                       4 * self.filters)

    def set_n_in(self, input_type: InputType, override: bool) -> None:
        if override or not self.n_in:
            self.n_in = input_type.channels
        self.n_out = 4 * self.filters

    def default_preprocessor(self, input_type: InputType):
        return None  # NHWC in and out: never flattened

    def param_shapes(self):
        f1, f3 = self.filters, 4 * self.filters
        shapes = {
            "W_a": (1, 1, self.n_in, f1), "gamma_a": (f1,), "beta_a": (f1,),
            "W_b": (3, 3, f1, f1), "gamma_b": (f1,), "beta_b": (f1,),
            "W_c": (1, 1, f1, f3), "gamma_c": (f3,), "beta_c": (f3,),
        }
        if self.project:
            shapes.update({"W_proj": (1, 1, self.n_in, f3),
                           "gamma_proj": (f3,), "beta_proj": (f3,)})
        return shapes

    def state_shapes(self):
        f1, f3 = self.filters, 4 * self.filters
        shapes = {"mean_a": (f1,), "var_a": (f1,),
                  "mean_b": (f1,), "var_b": (f1,),
                  "mean_c": (f3,), "var_c": (f3,)}
        if self.project:
            shapes.update({"mean_proj": (f3,), "var_proj": (f3,)})
        return shapes


@register_layer
@dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over time or space (the port reads the 4-D form)."""

    pooling_type: Any = "max"
    pooling_dimensions: Optional[Tuple[int, ...]] = None
    collapse_dimensions: bool = True
    pnorm: int = 2

    def get_output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        if input_type.kind == "cnn":
            return InputType.feed_forward(input_type.channels)
        return input_type


@register_layer
@dataclass
class GravesLSTM(BaseRecurrentLayer):
    """LSTM with Graves peepholes: `W` [n_in, 4n] (gate order i, f, o, g),
    `RW` [n, 4n], `pW` [3n] (p_i, p_f, p_o), `b` [4n] whose forget block
    [n, 2n) starts at `forget_gate_bias_init`."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Any = "sigmoid"

    def param_shapes(self):
        return {"W": (self.n_in, 4 * self.n_out),
                "RW": (self.n_out, 4 * self.n_out),
                "pW": (3 * self.n_out,),
                "b": (4 * self.n_out,)}


@register_layer
@dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Any = "sigmoid"

    def param_shapes(self):
        return {"W": (self.n_in, 4 * self.n_out),
                "RW": (self.n_out, 4 * self.n_out),
                "b": (4 * self.n_out,)}


@register_layer
@dataclass
class GravesBidirectionalLSTM(BaseRecurrentLayer):
    """Peephole LSTMs forward (`_f`) and backward (`_b`) in time; the
    output is their sum."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Any = "sigmoid"

    def param_shapes(self):
        shapes = {}
        for s in ("_f", "_b"):
            shapes.update({"W" + s: (self.n_in, 4 * self.n_out),
                           "RW" + s: (self.n_out, 4 * self.n_out),
                           "pW" + s: (3 * self.n_out,),
                           "b" + s: (4 * self.n_out,)})
        return shapes


@register_layer
@dataclass
class SimpleRnn(BaseRecurrentLayer):
    """h_t = act(x_t W + h_{t-1} RW + b)."""

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out),
                "RW": (self.n_out, self.n_out),
                "b": (self.n_out,)}


@register_layer
@dataclass
class LocalResponseNormalization(Layer):
    """Cross-channel LRN (k=2, n=5, alpha=1e-4, beta=0.75), no params."""

    k: float = 2.0
    n: float = 5.0
    alpha: float = 1e-4
    beta: float = 0.75


@register_layer
@dataclass
class MoELayer(FeedForwardLayer):
    """Mixture-of-experts FFN: `n_experts` experts of `expert_hidden`
    units (0: 4 * n_in at build time), top-k routing with capacity."""

    n_experts: int = 4
    expert_hidden: int = 0
    capacity_factor: float = 1.25
    top_k: int = 2
    router_jitter: float = 0.0
    aux_loss_weight: float = 1e-2
    activation: Any = "identity"

    def set_n_in(self, input_type: InputType, override: bool) -> None:
        super().set_n_in(input_type, override)
        if not self.expert_hidden:
            self.expert_hidden = 4 * self.n_in

    def param_shapes(self):
        e, h = self.n_experts, self.expert_hidden or 4 * self.n_in
        return {"gate_w": (self.n_in, e),
                "w1": (e, self.n_in, h), "b_1": (e, h),
                "w2": (e, h, self.n_out), "b_2": (e, self.n_out)}


@register_layer
@dataclass
class AutoEncoder(FeedForwardLayer):
    """Denoising autoencoder, pretrainable."""

    corruption_level: float = 0.3
    sparsity: float = 0.0
    loss_function: Any = "reconstruction_crossentropy"

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}


@register_layer
@dataclass
class RBM(FeedForwardLayer):
    """Restricted Boltzmann machine (CD-k), pretrainable."""

    visible_unit: str = "binary"
    hidden_unit: str = "binary"
    k: int = 1
    sparsity: float = 0.0
    loss_function: Any = "reconstruction_crossentropy"

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}


def _is_loss_wrapper(dist) -> bool:
    return (isinstance(dist, (list, tuple)) and len(dist) in (2, 3)
            and isinstance(dist[0], str) and dist[0] == "loss")


def dist_input_size(dist, data_size: int) -> int:
    """The decoder's output width for `data_size` features under a VAE
    reconstruction distribution (reference `layers/variational.py:41`)."""
    if _is_loss_wrapper(dist):
        return data_size
    if isinstance(dist, (list, tuple)):
        if sum(size for _, size in dist) != data_size:
            raise ValueError(
                "composite reconstruction distribution sizes "
                f"{[s for _, s in dist]} must sum to the data size "
                f"{data_size}")
        return sum(dist_input_size(name, size) for name, size in dist)
    if dist == "gaussian":
        return 2 * data_size
    if dist in ("bernoulli", "exponential"):
        return data_size
    raise ValueError(f"unknown reconstruction distribution {dist!r}")


@register_layer
@dataclass
class VariationalAutoencoder(FeedForwardLayer):
    """VAE: encoder and decoder MLP stacks, n_out = latent size, a
    reconstruction distribution; pretrainable."""

    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    reconstruction_distribution: Any = "gaussian"
    pzx_activation: Any = "identity"
    num_samples: int = 1

    def param_shapes(self):
        shapes: Dict[str, Tuple[int, ...]] = {}
        prev = self.n_in
        for i, size in enumerate(self.encoder_layer_sizes):
            shapes[f"eW{i}"] = (prev, size)
            shapes[f"eb{i}"] = (size,)
            prev = size
        shapes["pZXMeanW"] = (prev, self.n_out)
        shapes["pZXMeanB"] = (self.n_out,)
        shapes["pZXLogStd2W"] = (prev, self.n_out)
        shapes["pZXLogStd2B"] = (self.n_out,)
        prev = self.n_out
        for i, size in enumerate(self.decoder_layer_sizes):
            shapes[f"dW{i}"] = (prev, size)
            shapes[f"db{i}"] = (size,)
            prev = size
        size = dist_input_size(self.reconstruction_distribution, self.n_in)
        shapes["pXZW"] = (prev, size)
        shapes["pXZB"] = (size,)
        return shapes
