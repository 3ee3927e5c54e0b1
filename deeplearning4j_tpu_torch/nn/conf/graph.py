"""Graph vertex configurations of the serving slice (counterpart of
`deeplearning4j_tpu/nn/conf/graph.py`): `LayerVertex` and
`ElementWiseVertex`."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from deeplearning4j_tpu_torch.nn.conf.layers import Layer, layer_from_dict

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
    def apply(self, inputs):
        raise NotImplementedError

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


@register_vertex
@dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a layer as a vertex (input preprocessors are not in the port)."""

    layer: Optional[Layer] = None

    @classmethod
    def from_dict(cls, d):
        if d.get("preprocessor"):
            raise ValueError("input preprocessors are not in the port yet")
        return cls(layer=layer_from_dict(d["layer"]))


@register_vertex
@dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise op over equal-shape inputs; the port has "add" (the
    residual connections of `transformer_lm`)."""

    op: str = "add"

    def __post_init__(self):
        if self.op.lower() != "add":
            raise ValueError(f"ElementWiseVertex op {self.op!r} is not in "
                             "the port (it has 'add')")

    def apply(self, inputs):
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out
