"""Graph vertex configurations (counterpart of
`deeplearning4j_tpu/nn/conf/graph.py`): `LayerVertex` (a layer and its
optional input preprocessor) and the 13 vertices that are plain functions
of their inputs: Merge, ElementWise (add, subtract, product, average,
max), Subset, Stack, Unstack, Scale, Shift, L2, L2Normalize, Preprocessor,
LastTimeStep, DuplicateToTimeSeries and ReverseTimeSeries. `apply` is a
plain torch function of its inputs and their [b, t] features masks (the
engine's, `nn/graph.py`); autograd gives its gradient. Activations are
feature-last (NHWC images, [batch, time, features] sequences), so Merge,
Subset and the feature reductions act on the last axes. Under a mask,
`LastTimeStep` takes each example's last unmasked step and
`ReverseTimeSeries` reverses each example's unmasked prefix in place."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    preprocessor_from_dict,
)

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: dict):
    d = dict(d)
    kind = d.pop("@class")
    cls = _VERTEX_REGISTRY.get(kind)
    if cls is None:
        raise ValueError(f"graph vertex {kind} is not in the port; it has "
                         f"{sorted(_VERTEX_REGISTRY)}")
    return cls.from_dict(d)


@dataclass
class GraphVertexConf:
    def apply(self, inputs, masks=None):
        raise NotImplementedError

    def get_output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def to_dict(self) -> dict:
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            if k.startswith("_") or v is None:
                continue
            if isinstance(v, (Layer, InputPreProcessor)):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            d[k] = v
        return d

    @classmethod
    def from_dict(cls, d):
        unknown = sorted(set(d) - {f.name for f in dataclasses.fields(cls)})
        if unknown:
            raise ValueError(f"{cls.__name__} has no fields {unknown}")
        return cls(**d)


@register_vertex
@dataclass
class LayerVertex(GraphVertexConf):
    """A layer as a vertex, after its optional input preprocessor."""

    layer: Optional[Layer] = None
    preprocessor: Optional[InputPreProcessor] = None

    def get_output_type(self, *input_types):
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.get_output_type(it)
        return self.layer.get_output_type(it)

    @classmethod
    def from_dict(cls, d):
        unknown = sorted(set(d) - {"layer", "preprocessor"})
        if unknown:
            raise ValueError(f"LayerVertex has no fields {unknown}")
        return cls(
            layer=layer_from_dict(d["layer"]) if d.get("layer") else None,
            preprocessor=preprocessor_from_dict(d.get("preprocessor")))


@register_vertex
@dataclass
class MergeVertex(GraphVertexConf):
    """Concatenation on the feature (last) axis: the channels of NHWC
    images."""

    def apply(self, inputs, masks=None):
        return torch.cat(inputs, dim=-1)

    def get_output_type(self, *input_types):
        first = input_types[0]
        if first.kind == "cnn":
            return InputType.convolutional(
                first.height, first.width,
                sum(t.channels for t in input_types))
        total = sum(t.flat_size() for t in input_types)
        if first.kind == "rnn":
            return InputType.recurrent(total, first.timeseries_length)
        return InputType.feed_forward(total)


_ELEMENTWISE_OPS = ("add", "subtract", "product", "average", "max")


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise add, subtract (exactly two inputs), product, average or
    max of equal-shape inputs."""

    op: str = "add"

    def __post_init__(self):
        if self.op.lower() not in _ELEMENTWISE_OPS:
            raise ValueError(f"ElementWiseVertex op {self.op!r} is not one "
                             f"of {_ELEMENTWISE_OPS}")

    def apply(self, inputs, masks=None):
        op = self.op.lower()
        out = inputs[0]
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError("ElementWiseVertex subtract takes exactly "
                                 "2 inputs")
            return inputs[0] - inputs[1]
        if op == "average":
            return sum(inputs) / len(inputs)
        for x in inputs[1:]:
            if op == "add":
                out = out + x
            elif op == "product":
                out = out * x
            else:
                out = torch.maximum(out, x)
        return out


@register_vertex
@dataclass
class SubsetVertex(GraphVertexConf):
    """Features [from_index, to_index] (inclusive) of the last axis."""

    from_index: int = 0
    to_index: int = 0

    def apply(self, inputs, masks=None):
        return inputs[0][..., self.from_index:self.to_index + 1]

    def get_output_type(self, *input_types):
        n = self.to_index - self.from_index + 1
        it = input_types[0]
        if it.kind == "rnn":
            return InputType.recurrent(n, it.timeseries_length)
        if it.kind == "cnn":
            return InputType.convolutional(it.height, it.width, n)
        return InputType.feed_forward(n)


@register_vertex
@dataclass
class StackVertex(GraphVertexConf):
    """The inputs stacked on the batch axis."""

    def apply(self, inputs, masks=None):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclass
class UnstackVertex(GraphVertexConf):
    """Part `from_index` of `stack_size` equal parts of the batch axis."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, inputs, masks=None):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@register_vertex
@dataclass
class ScaleVertex(GraphVertexConf):
    scale_factor: float = 1.0

    def apply(self, inputs, masks=None):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclass
class ShiftVertex(GraphVertexConf):
    shift_factor: float = 0.0

    def apply(self, inputs, masks=None):
        return inputs[0] + self.shift_factor


@register_vertex
@dataclass
class L2Vertex(GraphVertexConf):
    """The L2 distance of two inputs per example, [batch, 1]:
    sqrt(max(d2, eps)), whose gradient at a == b is 0, not NaN."""

    eps: float = 1e-8

    def apply(self, inputs, masks=None):
        a, b = inputs
        d2 = ((a - b) ** 2).sum(dim=tuple(range(1, a.dim())))
        return torch.sqrt(torch.clamp(d2, min=self.eps))[:, None]

    def get_output_type(self, *input_types):
        return InputType.feed_forward(1)


@register_vertex
@dataclass
class L2NormalizeVertex(GraphVertexConf):
    """Each example over its L2 norm (at least eps)."""

    eps: float = 1e-8

    def apply(self, inputs, masks=None):
        x = inputs[0]
        norm = torch.sqrt((x ** 2).sum(dim=tuple(range(1, x.dim())),
                                       keepdim=True))
        return x / torch.clamp(norm, min=self.eps)


@register_vertex
@dataclass
class PreprocessorVertex(GraphVertexConf):
    """An input preprocessor as a vertex of its own."""

    preprocessor: Optional[InputPreProcessor] = None

    def apply(self, inputs, masks=None):
        return self.preprocessor(inputs[0], masks[0] if masks else None)[0]

    def get_output_type(self, *input_types):
        return self.preprocessor.get_output_type(input_types[0])

    @classmethod
    def from_dict(cls, d):
        return cls(preprocessor=preprocessor_from_dict(d.get("preprocessor")))


@register_vertex
@dataclass
class LastTimeStepVertex(GraphVertexConf):
    """[b, t, f] -> [b, f], the last step, or under a mask each example's
    last unmasked one (step 0 if none is); the engine passes the mask of
    `mask_array_input` when it is set."""

    mask_array_input: Optional[str] = None

    def apply(self, inputs, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :]
        idx = (mask.sum(dim=1).long() - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def get_output_type(self, *input_types):
        return InputType.feed_forward(input_types[0].size)


@register_vertex
@dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[b, f] -> [b, t, f], t the length of the sequence `input_name` (the
    engine passes it)."""

    input_name: Optional[str] = None

    def apply(self, inputs, masks=None, time_steps: int = 1):
        x = inputs[0]
        return x[:, None, :].expand(x.shape[0], time_steps, x.shape[1])

    def get_output_type(self, *input_types):
        return InputType.recurrent(input_types[0].flat_size())


@register_vertex
@dataclass
class ReverseTimeSeriesVertex(GraphVertexConf):
    """The time axis reversed; under a mask only each example's unmasked
    prefix [0, len), the padding staying at the tail."""

    mask_array_input: Optional[str] = None

    def apply(self, inputs, masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return torch.flip(x, dims=(1,))
        lengths = mask.sum(dim=1).long()[:, None]            # [b, 1]
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        src = torch.where(pos < lengths, lengths - 1 - pos, pos)
        return torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[2]))
