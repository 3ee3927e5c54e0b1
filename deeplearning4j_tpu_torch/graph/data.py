"""Graph loaders.

The port's copy of `deeplearning4j_tpu/graph/data.py`, which is host code
(Python and numpy) and computes the same.

Equivalent of the reference's `graph/data/GraphLoader.java` with
`DelimitedEdgeLineProcessor` / `WeightedEdgeLineProcessor` /
`DelimitedVertexLoader` — parse "from<delim>to[<delim>weight]" edge-list
files into a `Graph`.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.graph.api import Graph


def load_undirected_graph(path: str, num_vertices: int, delim: str = ",",
                          directed: bool = False) -> Graph:
    """Unweighted edge list, one "from<delim>to" per line; lines starting
    with `#` are comments (reference: `GraphLoader.loadUndirectedGraphEdgeListFile`)."""
    g = Graph(num_vertices)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delim)
            g.add_edge(int(parts[0]), int(parts[1]), directed=directed)
    return g


def load_weighted_graph(path: str, num_vertices: int, delim: str = ",",
                        directed: bool = False) -> Graph:
    """Weighted edge list "from<delim>to<delim>weight" (reference:
    `WeightedEdgeLineProcessor`)."""
    g = Graph(num_vertices)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delim)
            g.add_edge(int(parts[0]), int(parts[1]), float(parts[2]),
                       directed=directed)
    return g
