"""DeepWalk graph embeddings (counterpart of
`deeplearning4j_tpu/graph/deepwalk.py`).

Equivalent of the reference's `graph/models/deepwalk/DeepWalk.java:29`
(Perozzi et al. 2014: skip-gram with hierarchical softmax over random
walks), `GraphHuffman.java` (Huffman tree over vertex DEGREES driving the
HS codes), `models/embeddings/InMemoryGraphLookupTable.java` (per-pair HS
sigmoid update) and the query API `GraphVectorsImpl.java` +
`GraphVectorSerializer.java`.

The reference trains pair-at-a-time from N walker threads; here every walk
window is flattened into (center, target-path) pairs and pushed through the
same batched `ops/skipgram.hs_skipgram_step` update Word2Vec uses, on the
tables' device. As in the reference, a flush's [B, L] Huffman paths are
gathered on the host (`:157-161` there) and uploaded with its centers and
mask, through pinned staging (`ops.skipgram.Uploader`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling
from deeplearning4j_tpu_torch.graph.iterators import random_walks
from deeplearning4j_tpu_torch.nlp.word2vec import host, to_table
from deeplearning4j_tpu_torch.ops import skipgram as kernels
# GraphHuffman parity: same Huffman core as word2vec, keyed on vertex
# degree with 64-bit code capacity (`GraphHuffman.java` packs codes in a
# long).
from deeplearning4j_tpu_torch.util.huffman import huffman_codes


class GraphVectors:
    """Query API over trained vertex vectors (reference:
    `GraphVectorsImpl.java:21` — getVertexVector / similarity /
    verticesNearest)."""

    def __init__(self, syn0):
        self.syn0 = host(syn0)
        norms = np.linalg.norm(self.syn0, axis=1, keepdims=True)
        self._unit = self.syn0 / np.maximum(norms, 1e-12)

    def num_vertices(self) -> int:
        return self.syn0.shape[0]

    def get_vector_size(self) -> int:
        return self.syn0.shape[1]

    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self.syn0[idx]

    def similarity(self, i: int, j: int) -> float:
        return float(self._unit[i] @ self._unit[j])

    def vertices_nearest(self, idx: int, top: int = 10) -> np.ndarray:
        sims = self._unit @ self._unit[idx]
        order = np.argsort(-sims)
        return order[order != idx][:top].astype(np.int32)

    # ----------------------------------------------------------------- io

    def save(self, path: str) -> None:
        """Text format: one "idx<TAB>v0 v1 ..." line per vertex (reference:
        `GraphVectorSerializer.writeGraphVectors`)."""
        with open(path, "w") as f:
            for i, row in enumerate(self.syn0):
                f.write(f"{i}\t" + " ".join(f"{x:.8g}" for x in row) + "\n")

    @classmethod
    def load(cls, path: str) -> "GraphVectors":
        rows = {}
        with open(path) as f:
            for line in f:
                idx, vec = line.rstrip("\n").split("\t")
                rows[int(idx)] = np.asarray([float(x) for x in vec.split()])
        syn0 = np.stack([rows[i] for i in range(len(rows))]).astype(np.float32)
        return cls(syn0)


class DeepWalk(GraphVectors):
    """DeepWalk trainer (builder parity with `DeepWalk.Builder`:
    vector_size, window_size, learning_rate, seed; plus walk/epoch controls
    that the reference passes to `fit(graph, walkLength)`). `device`: the
    card unless the caller asks for the CPU."""

    def __init__(self, *, vector_size: int = 100, window_size: int = 2,
                 learning_rate: float = 0.01, seed: int = 12345,
                 epochs: int = 1, batch_size: int = 4096,
                 weighted_walks: bool = False,
                 no_edge_handling: NoEdgeHandling = NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED,
                 device="cuda"):
        self.device = resolve_device(device)
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.seed = seed
        self.epochs = epochs
        self.batch_size = batch_size
        self.weighted_walks = weighted_walks
        self.no_edge_handling = no_edge_handling
        self.syn0 = None
        self._init_called = False

    # -------------------------------------------------------------- setup

    def initialize(self, graph_or_degrees) -> "DeepWalk":
        """Build the degree-keyed Huffman tree + tables (reference:
        `DeepWalk.initialize` — "vertex degrees are used to construct a
        binary (Huffman) tree")."""
        if isinstance(graph_or_degrees, Graph):
            degrees = graph_or_degrees.degrees()
        else:
            degrees = np.asarray(graph_or_degrees, np.int64)
        V, D = len(degrees), self.vector_size
        codes, points, n_inner = huffman_codes(np.maximum(degrees, 1))
        max_code = max((len(c) for c in codes), default=1) or 1
        self._codes_tbl = np.zeros((V, max_code), np.int32)
        self._points_tbl = np.zeros((V, max_code), np.int32)
        self._cmask_tbl = np.zeros((V, max_code), np.float32)
        for i, (c, p) in enumerate(zip(codes, points)):
            self._codes_tbl[i, : len(c)] = c
            self._points_tbl[i, : len(c)] = p
            self._cmask_tbl[i, : len(c)] = 1.0
        rng = np.random.RandomState(self.seed)
        # Reference init (InMemoryGraphLookupTable): small uniform vectors,
        # zero inner-node weights.
        self._syn0 = to_table(
            ((rng.rand(V, D) - 0.5) / D).astype(np.float32), self.device)
        self._syn1 = torch.zeros((n_inner, D), dtype=torch.float32,
                                 device=self.device)
        self._walk_rng = rng
        self._init_called = True
        return self

    # ---------------------------------------------------------------- fit

    def fit(self, graph: Graph, walk_length: int = 40) -> "DeepWalk":
        if not self._init_called:
            self.initialize(graph)
        w = self.window_size
        B = self.batch_size
        lr = float(np.float32(self.learning_rate))
        up = kernels.Uploader(self.device)

        for _ in range(self.epochs):
            walks = random_walks(
                graph, walk_length, rng=self._walk_rng,
                no_edge_handling=self.no_edge_handling,
                weighted=self.weighted_walks)
            centers, targets = self._skipgram_pairs(walks, w)
            n = len(centers)
            for start in range(0, n, B):
                c = centers[start:start + B]
                t = targets[start:start + B]
                fill = len(c)
                bc = np.zeros(B, np.int32)
                bt = np.zeros(B, np.int32)
                pm = np.zeros(B, np.float32)
                bc[:fill] = c
                bt[:fill] = t
                pm[:fill] = 1.0
                kernels.hs_skipgram_step(
                    self._syn0, self._syn1, *up.put(
                        bc, self._codes_tbl[bt], self._points_tbl[bt],
                        self._cmask_tbl[bt], pm), lr)
                up.done()
        GraphVectors.__init__(self, self._syn0)
        return self

    @staticmethod
    def _skipgram_pairs(walks: np.ndarray, window: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Flatten walks into (center, target) pairs with the reference's
        exact window rule (`DeepWalk.skipGram`: mid ranges over
        [window, len-window), pairing walk[mid] with walk[mid±1..window])."""
        B, L = walks.shape
        mids = np.arange(window, L - window)
        if len(mids) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        offsets = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
        centers = np.repeat(walks[:, mids], len(offsets), axis=1).reshape(-1)
        targets = walks[:, (mids[:, None] + offsets[None, :]).reshape(-1)].reshape(-1)
        return centers.astype(np.int32), targets.astype(np.int32)
