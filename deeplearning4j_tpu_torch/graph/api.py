"""Graph API.

The port's copy of `deeplearning4j_tpu/graph/api.py`, which is host code
(Python and numpy) and computes the same.

Equivalent of the reference's `deeplearning4j-graph` core abstractions —
`graph/api/IGraph.java:17`, `graph/api/Vertex.java`, `graph/api/Edge.java`,
`graph/api/NoEdgeHandling.java`, and the adjacency-list implementation
`graph/graph/Graph.java:26`. The reference stores per-vertex Java edge lists;
here the graph additionally compiles itself to padded numpy neighbor/weight
tables (`neighbor_table()`) so random walks run vectorized over a whole batch
of walkers at once (see `graph/iterators.py`) instead of one
vertex-at-a-time.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


class NoEdgeHandling(Enum):
    """What a walk does at a vertex with no outgoing edges (reference:
    `graph/api/NoEdgeHandling.java`)."""

    SELF_LOOP_ON_DISCONNECTED = "self_loop"
    EXCEPTION_ON_DISCONNECTED = "exception"


class NoEdgesException(RuntimeError):
    """Reference: `graph/exception/NoEdgesException.java`."""


@dataclass
class Vertex:
    """A vertex: integer id + arbitrary value (reference `Vertex.java`)."""

    idx: int
    value: Any = None

    def vertex_id(self) -> int:
        return self.idx


@dataclass
class Edge:
    """An edge (reference `Edge.java`); `value` doubles as the weight for
    weighted walks when numeric."""

    frm: int
    to: int
    value: Any = None
    directed: bool = False


class Graph:
    """Adjacency-list graph (reference: `graph/graph/Graph.java:26` +
    `BaseGraph.java`). Undirected edges are stored in both directions."""

    def __init__(self, num_vertices: int,
                 vertices: Optional[Sequence[Any]] = None):
        if num_vertices <= 0:
            raise ValueError("num_vertices must be positive")
        self._vertices = [
            Vertex(i, vertices[i] if vertices is not None else None)
            for i in range(num_vertices)
        ]
        self._adj: List[List[Tuple[int, float]]] = [[] for _ in range(num_vertices)]
        self._edges: List[Edge] = []
        self._tables: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    # ------------------------------------------------------------ mutation

    def add_edge(self, frm: int, to: int, value: Any = None,
                 directed: bool = False) -> None:
        if not (0 <= frm < self.num_vertices() and 0 <= to < self.num_vertices()):
            raise ValueError(f"edge ({frm},{to}) out of range")
        weight = float(value) if isinstance(value, (int, float)) else 1.0
        self._edges.append(Edge(frm, to, value, directed))
        self._adj[frm].append((to, weight))
        if not directed:
            self._adj[to].append((frm, weight))
        self._tables = None

    # ------------------------------------------------------------- queries

    def num_vertices(self) -> int:
        return len(self._vertices)

    def num_edges(self) -> int:
        return len(self._edges)

    def get_vertex(self, idx: int) -> Vertex:
        return self._vertices[idx]

    def get_vertices(self, indexes: Sequence[int]) -> List[Vertex]:
        return [self._vertices[i] for i in indexes]

    def get_vertex_degree(self, vertex: int) -> int:
        return len(self._adj[vertex])

    def get_edges_out(self, vertex: int) -> List[Edge]:
        return [e for e in self._edges
                if e.frm == vertex or (not e.directed and e.to == vertex)]

    def get_connected_vertex_indices(self, vertex: int) -> np.ndarray:
        return np.asarray([t for t, _ in self._adj[vertex]], np.int32)

    def get_connected_vertices(self, vertex: int) -> List[Vertex]:
        return [self._vertices[t] for t, _ in self._adj[vertex]]

    def get_random_connected_vertex(self, vertex: int,
                                    rng: np.random.RandomState) -> Vertex:
        if not self._adj[vertex]:
            raise NoEdgesException(f"vertex {vertex} has no outgoing edges")
        t, _ = self._adj[vertex][rng.randint(len(self._adj[vertex]))]
        return self._vertices[t]

    def degrees(self) -> np.ndarray:
        return np.asarray([len(a) for a in self._adj], np.int32)

    # --------------------------------------------------- vectorized tables

    def neighbor_table(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Padded (neighbors [V, max_deg], cum_weights [V, max_deg],
        degrees [V]) for batched walk stepping. Cached until the edge set
        changes."""
        if self._tables is None:
            V = self.num_vertices()
            max_deg = max((len(a) for a in self._adj), default=0)
            max_deg = max(max_deg, 1)
            nbrs = np.zeros((V, max_deg), np.int32)
            cumw = np.zeros((V, max_deg), np.float64)
            degs = self.degrees()
            for v, adj in enumerate(self._adj):
                if adj:
                    nbrs[v, : len(adj)] = [t for t, _ in adj]
                    cumw[v, : len(adj)] = np.cumsum([w for _, w in adj])
                    # Pad the cumulative row with the total so searchsorted
                    # never lands on a padding slot.
                    cumw[v, len(adj):] = cumw[v, len(adj) - 1]
            self._tables = (nbrs, cumw, degs)
        return self._tables
