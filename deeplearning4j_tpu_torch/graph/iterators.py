"""Random-walk generation.

The port's copy of `deeplearning4j_tpu/graph/iterators.py`, which is host code
(Python and numpy) and computes the same.

Equivalent of the reference's `graph/iterator/RandomWalkIterator.java` and
`WeightedRandomWalkIterator.java` (one walk per start vertex, fixed length,
`NoEdgeHandling` for disconnected vertices) plus the parallel providers
(`graph/iterator/parallel/`). The reference steps one walker at a time from
Java; here ALL walkers advance together — each step is one vectorized
numpy gather/sample over the padded neighbor table, which is also the shape
a device-resident walk kernel would take.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling, NoEdgesException


def random_walks(graph: Graph, walk_length: int,
                 starts: Optional[np.ndarray] = None,
                 rng: Optional[np.random.RandomState] = None,
                 no_edge_handling: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 weighted: bool = False) -> np.ndarray:
    """Generate `[num_starts, walk_length + 1]` vertex-index walks, one per
    start vertex (reference semantics: `RandomWalkIterator.next()` produces
    walkLength+1 vertices including the start). `weighted=True` samples
    neighbors proportional to edge weight (`WeightedRandomWalkIterator`)."""
    rng = rng or np.random.RandomState(0)
    nbrs, cumw, degs = graph.neighbor_table()
    if starts is None:
        starts = np.arange(graph.num_vertices(), dtype=np.int32)
    starts = np.asarray(starts, np.int32)

    B = len(starts)
    walks = np.empty((B, walk_length + 1), np.int32)
    walks[:, 0] = starts
    cur = starts.copy()
    for step in range(walk_length):
        d = degs[cur]
        connected = d > 0
        # Reference semantics: only a walk that actually LANDS on an
        # edgeless vertex throws (`RandomWalkIterator.next` —
        # GENERATE_STRICT); unreachable isolated vertices are fine.
        if (no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED
                and not np.all(connected)):
            bad = int(cur[np.argmin(connected)])
            raise NoEdgesException(
                f"walk reached vertex {bad} which has no edges "
                "(EXCEPTION_ON_DISCONNECTED)")
        if weighted:
            total = cumw[cur, np.maximum(d - 1, 0)]
            u = rng.rand(B) * total
            # Per-row binary search over the padded cumulative weights.
            choice = np.sum(cumw[cur] < u[:, None], axis=1).astype(np.int64)
            choice = np.minimum(choice, np.maximum(d - 1, 0))
        else:
            choice = (rng.rand(B) * np.maximum(d, 1)).astype(np.int64)
        nxt = nbrs[cur, choice]
        # SELF_LOOP_ON_DISCONNECTED: a degree-0 walker stays put.
        cur = np.where(connected, nxt, cur).astype(np.int32)
        walks[:, step + 1] = cur
    return walks


class RandomWalkIterator:
    """Iterator facade over `random_walks` yielding one walk at a time
    (reference: `GraphWalkIterator` contract — `has_next`/`next`/`reset`/
    `walk_length`)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 0,
                 no_edge_handling: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 weighted: bool = False):
        self.graph = graph
        self._walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.weighted = weighted
        self.reset()

    def walk_length(self) -> int:
        return self._walk_length

    def reset(self) -> None:
        self._walks = random_walks(
            self.graph, self._walk_length,
            rng=np.random.RandomState(self.seed),
            no_edge_handling=self.no_edge_handling, weighted=self.weighted)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._walks)

    def next(self) -> np.ndarray:
        walk = self._walks[self._pos]
        self._pos += 1
        return walk

    def __iter__(self) -> Iterator[np.ndarray]:
        while self.has_next():
            yield self.next()
