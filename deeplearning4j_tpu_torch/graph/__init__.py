"""Graph embeddings (counterpart of `deeplearning4j_tpu/graph/`): the graph
API, loaders, random walks and DeepWalk."""

from deeplearning4j_tpu_torch.graph.api import (
    Edge, Graph, NoEdgeHandling, Vertex,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphVectors

__all__ = ["Edge", "Graph", "NoEdgeHandling", "Vertex", "DeepWalk",
           "GraphVectors"]
