"""Input preprocessors (counterpart of
`deeplearning4j_tpu/nn/conf/preprocessors.py`): the shape adapters that
`MultiLayerConfiguration` runs before a layer, read from the reference's
JSON by their `@class` name. Each is `(x, mask) -> (x, mask)` on tensors,
forward only: autograd restores the shape on the way back.

Layouts are the reference's, feature-last: NHWC images, `[batch, time,
features]` sequences. So `CnnToFeedForwardPreProcessor` flattens (h, w, c)
row-major, the order a dense layer's `W` rows follow after it, and
`FeedForwardToCnnPreProcessor` unflattens NHWC, not DL4J's NCHW (the
reference's note). Dense layers act on the last axis, so the Rnn <->
FeedForward pair leaves the data as it is.

The uint8 wire policy (reference `preprocessors.py:223-264`) decides what
a uint8 network input means from the layers it feeds: image bytes scaled
0-255 to 0-1 on the device for value consumers, ids cast (unscaled) for an
ids-format `EmbeddingLayer`, refused when both kinds read it. Integer ids
of any other dtype pass through untouched.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

_PREPROCESSOR_REGISTRY: Dict[str, type] = {}


def register_preprocessor(cls):
    _PREPROCESSOR_REGISTRY[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d):
    if d is None:
        return None
    d = dict(d)
    kind = d.pop("@class")
    if kind == "ComposableInputPreProcessor":
        return ComposableInputPreProcessor(
            *[preprocessor_from_dict(p) for p in d["preprocessors"]])
    cls = _PREPROCESSOR_REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"unknown preprocessor {kind!r}; the port has "
                         f"{sorted(_PREPROCESSOR_REGISTRY)}")
    unknown = sorted(set(d) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise ValueError(f"{kind} has no fields {unknown}")
    if isinstance(d.get("target_shape"), list):
        d["target_shape"] = tuple(d["target_shape"])
    return cls(**d)


@dataclass
class InputPreProcessor:
    def __call__(self, x, mask=None):
        """(transformed activations, transformed mask)."""
        return x, mask

    def get_output_type(self, input_type: InputType) -> InputType:
        return input_type

    def to_dict(self) -> dict:
        d = {"@class": type(self).__name__}
        d.update({k: v for k, v in self.__dict__.items()
                  if not k.startswith("_")})
        return d


@register_preprocessor
@dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """[b, h, w, c] -> [b, h * w * c], flattened (h, w, c) row-major."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x, mask=None):
        return x.reshape(x.shape[0], -1), mask

    def get_output_type(self, input_type):
        return InputType.feed_forward(
            input_type.height * input_type.width * input_type.channels)


@register_preprocessor
@dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """[b, h * w * c] -> [b, h, w, c] (NHWC, as the reference unflattens)."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x, mask=None):
        return x.reshape(x.shape[0], self.input_height, self.input_width,
                         self.num_channels), mask

    def get_output_type(self, input_type):
        return InputType.convolutional(self.input_height, self.input_width,
                                       self.num_channels)


@register_preprocessor
@dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """Identity on data (dense layers broadcast over time)."""

    def get_output_type(self, input_type):
        if input_type.kind == "ff":
            return InputType.recurrent(input_type.size)
        return input_type


@register_preprocessor
@dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """Identity on data (dense layers broadcast over time)."""

    def get_output_type(self, input_type):
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        return input_type


@register_preprocessor
@dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """[b, h, w, c] -> [b, 1, h * w * c] (one time step); [b, t, h, w, c]
    -> [b, t, h * w * c]."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x, mask=None):
        if x.dim() == 4:
            return x.reshape(x.shape[0], 1, -1), mask
        return x.reshape(x.shape[0], x.shape[1], -1), mask

    def get_output_type(self, input_type):
        return InputType.recurrent(
            input_type.height * input_type.width * input_type.channels)


@register_preprocessor
@dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """[b, t, h * w * c] -> [b, t, h, w, c]."""

    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def __call__(self, x, mask=None):
        return x.reshape(x.shape[0], x.shape[1], self.input_height,
                         self.input_width, self.num_channels), mask

    def get_output_type(self, input_type):
        return InputType.convolutional(self.input_height, self.input_width,
                                       self.num_channels)


@register_preprocessor
@dataclass
class ReshapePreProcessor(InputPreProcessor):
    """Reshape to `target_shape`, keeping the batch axis."""

    target_shape: Optional[Tuple[int, ...]] = None

    def __call__(self, x, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.target_shape or ())), mask


class ComposableInputPreProcessor(InputPreProcessor):
    """A chain of preprocessors, applied in order."""

    def __init__(self, *preprocessors):
        self.preprocessors = list(preprocessors)

    def __eq__(self, other):
        return (isinstance(other, ComposableInputPreProcessor)
                and self.preprocessors == other.preprocessors)

    def __repr__(self):
        return f"ComposableInputPreProcessor{tuple(self.preprocessors)!r}"

    def __call__(self, x, mask=None):
        for p in self.preprocessors:
            x, mask = p(x, mask)
        return x, mask

    def get_output_type(self, input_type):
        for p in self.preprocessors:
            input_type = p.get_output_type(input_type)
        return input_type

    def to_dict(self) -> dict:
        return {"@class": "ComposableInputPreProcessor",
                "preprocessors": [p.to_dict() for p in self.preprocessors]}


_PREPROCESSOR_REGISTRY["ComposableInputPreProcessor"] = \
    ComposableInputPreProcessor


# ------------------------------------------------------------------------
# uint8 network-input policy (reference `preprocessors.py:223-264`).

UINT8_SCALE = "scale"          # image bytes: to the compute dtype, / 255
UINT8_IDS = "ids"              # embedding ids: cast to int64, not scaled
UINT8_AMBIGUOUS = "ambiguous"  # ids and values: refused if uint8 arrives


def _consumes_ids(layer) -> bool:
    return (type(layer).__name__ == "EmbeddingLayer"
            and getattr(layer, "input_format", "auto") != "onehot")


def resolve_uint8_policy(consumers) -> str:
    """What a uint8 network input means, from the layers it feeds directly
    (None for a vertex that is not a layer: a value consumer)."""
    kinds = {UINT8_IDS if layer is not None and _consumes_ids(layer)
             else UINT8_SCALE for layer in consumers}
    if len(kinds) > 1:
        return UINT8_AMBIGUOUS
    return kinds.pop() if kinds else UINT8_SCALE


def apply_uint8_policy(x: torch.Tensor, policy: str,
                       compute_dtype: torch.dtype) -> torch.Tensor:
    """One network input as the forward reads it: uint8 by `policy`,
    floats at the compute dtype, integer ids as they are."""
    if x.dtype == torch.uint8:
        if policy == UINT8_IDS:
            return x.long()
        if policy == UINT8_AMBIGUOUS:
            raise ValueError(
                "uint8 network input is ambiguous: it feeds both an "
                "ids-format EmbeddingLayer (wants raw ids) and a value "
                "consumer (wants /255 image scaling). Feed ids as "
                "int32/int64 or split the input so each consumer gets its "
                "own.")
        return x.to(compute_dtype) / 255.0
    if x.is_floating_point():
        return x.to(compute_dtype)
    return x
