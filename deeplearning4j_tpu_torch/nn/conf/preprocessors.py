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

The reference's uint8 wire policy (`preprocessors.py:223-264`) is not
here: the port's engines take ids as integer tensors as they come.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
