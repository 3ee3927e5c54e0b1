"""The port's graph embeddings against the JAX package, on the CPU: the
graph API and its loaders, the random walks (exactly, from the same numpy
generator), the degree-keyed Huffman tables, the skip-gram pairs, DeepWalk's
vectors (within 1e-4 of the reference's after a whole fit, 1e-5 after one
flush), `GraphVectors` files read across the packages, and a
reference-trained DeepWalk continued in the port through
`interop.embeddings_from_numpy`.

Small sizes: graphs of 60 to 200 vertices, D = 16.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.graph import api as jax_api
from deeplearning4j_tpu.graph import data as jax_data
from deeplearning4j_tpu.graph import deepwalk as jax_dw
from deeplearning4j_tpu.graph import iterators as jax_it
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.graph import (
    DeepWalk, Graph, GraphVectors, NoEdgeHandling,
)
from deeplearning4j_tpu_torch.graph import data, iterators
from deeplearning4j_tpu_torch.graph.api import NoEdgesException

OP_TOL = 1e-5
FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_rnn_slice.py`)."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def planted_partition(n, k, deg_in, deg_out, seed, weighted=False):
    """Edges of a graph of n vertices in k equal communities: about deg_in
    neighbours inside a vertex's community and deg_out outside."""
    rng = np.random.RandomState(seed)
    size = n // k
    edges = []
    for v in range(n):
        c = v // size
        for u in rng.randint(0, size, deg_in // 2) + c * size:
            if u != v:
                edges.append((v, int(u)))
        for u in rng.randint(0, n, max(deg_out // 2, 0)):
            if u // size != c:
                edges.append((v, int(u)))
    w = rng.rand(len(edges)) * 3 + 0.1 if weighted else [None] * len(edges)
    return [(a, b, None if x is None else float(x))
            for (a, b), x in zip(edges, w)]


def both_graphs(n, edges, isolated=()):
    gp, gj = Graph(n), jax_api.Graph(n)
    for a, b, w in edges:
        if a in isolated or b in isolated:
            continue
        gp.add_edge(a, b, w)
        gj.add_edge(a, b, w)
    return gp, gj


def test_graph_api_and_tables_equal():
    gp, gj = both_graphs(60, planted_partition(60, 3, 8, 2, 1, True))
    assert gp.num_edges() == gj.num_edges()
    assert np.array_equal(gp.degrees(), gj.degrees())
    for a, b in zip(gp.neighbor_table(), gj.neighbor_table()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert gp.get_connected_vertex_indices(5).tolist() == \
        gj.get_connected_vertex_indices(5).tolist()
    assert [e.to for e in gp.get_edges_out(7)] == \
        [e.to for e in gj.get_edges_out(7)]
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    assert gp.get_random_connected_vertex(4, r1).idx == \
        gj.get_random_connected_vertex(4, r2).idx
    with pytest.raises(ValueError, match="out of range"):
        gp.add_edge(0, 60)
    with pytest.raises(ValueError, match="positive"):
        Graph(0)


@pytest.mark.parametrize("weighted", [False, True])
def test_loaders_equal(tmp_path, weighted):
    path = tmp_path / "edges.csv"
    lines = ["# a comment", ""]
    for a, b, w in planted_partition(40, 2, 6, 2, 2, True):
        lines.append(f"{a},{b},{w}" if weighted else f"{a},{b}")
    path.write_text("\n".join(lines) + "\n")
    load_p = data.load_weighted_graph if weighted else \
        data.load_undirected_graph
    load_j = jax_data.load_weighted_graph if weighted else \
        jax_data.load_undirected_graph
    gp, gj = load_p(str(path), 40), load_j(str(path), 40)
    for a, b in zip(gp.neighbor_table(), gj.neighbor_table()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_random_walks_equal(weighted):
    # Vertex 59 has no edges: its walks stay put (SELF_LOOP).
    gp, gj = both_graphs(60, planted_partition(60, 3, 8, 2, 4, weighted),
                         isolated={59})
    for starts in (None, np.asarray([0, 59, 30, 30], np.int32)):
        got = iterators.random_walks(gp, 12, starts=starts,
                                     rng=np.random.RandomState(9),
                                     weighted=weighted)
        want = jax_it.random_walks(gj, 12, starts=starts,
                                   rng=np.random.RandomState(9),
                                   weighted=weighted)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got[1] == 59).all()
    it_p = iterators.RandomWalkIterator(gp, 5, seed=2, weighted=weighted)
    it_j = jax_it.RandomWalkIterator(gj, 5, seed=2, weighted=weighted)
    assert [w.tolist() for w in it_p] == [w.tolist() for w in it_j]
    assert it_p.walk_length() == 5 and not it_p.has_next()
    it_p.reset()
    assert it_p.has_next()


def test_walk_onto_an_edgeless_vertex_raises():
    g = Graph(3)
    g.add_edge(0, 1, directed=True)
    with pytest.raises(NoEdgesException, match="vertex 1"):
        iterators.random_walks(
            g, 3, starts=np.asarray([0]),
            no_edge_handling=NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)


def test_skipgram_pairs_and_huffman_tables_equal():
    walks = np.random.RandomState(5).randint(0, 50, (7, 11)).astype(np.int32)
    for w in (1, 2, 3, 6):
        for a, b in zip(DeepWalk._skipgram_pairs(walks, w),
                        jax_dw.DeepWalk._skipgram_pairs(walks, w)):
            assert np.array_equal(a, b)
    degrees = np.random.RandomState(6).randint(0, 9, 80)
    p = DeepWalk(vector_size=16, device="cpu").initialize(degrees)
    j = jax_dw.DeepWalk(vector_size=16).initialize(degrees)
    for name in ("_codes_tbl", "_points_tbl", "_cmask_tbl"):
        assert np.array_equal(getattr(p, name), getattr(j, name))
    assert np.array_equal(p._syn0.numpy(), np.asarray(j._syn0))
    assert p._syn1.shape == j._syn1.shape


DW_KW = dict(vector_size=16, window_size=2, learning_rate=0.05, seed=3,
             batch_size=256)


@pytest.mark.parametrize("weighted", [False, True])
def test_deepwalk_matches_reference(weighted):
    gp, gj = both_graphs(150, planted_partition(150, 5, 10, 2, 7, weighted))
    kw = dict(DW_KW, epochs=2, weighted_walks=weighted)
    p = DeepWalk(device="cpu", **kw).fit(gp, walk_length=10)
    j = jax_dw.DeepWalk(**kw).fit(gj, walk_length=10)
    assert rel(p.syn0, j.syn0) <= FIT_TOL
    assert rel(p._syn1, np.asarray(j._syn1)) <= FIT_TOL
    assert p.vertices_nearest(3, 5).tolist() == \
        j.vertices_nearest(3, 5).tolist()
    assert p.num_vertices() == 150 and p.get_vector_size() == 16


def test_deepwalk_first_flush_within_op_tolerance():
    gp, gj = both_graphs(200, planted_partition(200, 4, 10, 2, 8))
    kw = dict(DW_KW, batch_size=100000)  # one flush holds every pair
    p = DeepWalk(device="cpu", **kw).fit(gp, walk_length=8)
    j = jax_dw.DeepWalk(**kw).fit(gj, walk_length=8)
    assert rel(p.syn0, j.syn0) <= OP_TOL
    assert rel(p._syn1, np.asarray(j._syn1)) <= OP_TOL


def test_graph_vectors_files_across_packages(tmp_path):
    syn0 = np.random.RandomState(9).randn(30, 16).astype(np.float32)
    a, b = tmp_path / "p.txt", tmp_path / "j.txt"
    GraphVectors(syn0).save(str(a))
    jax_dw.GraphVectors(syn0).save(str(b))
    assert a.read_bytes() == b.read_bytes()
    for got in (GraphVectors.load(str(b)), jax_dw.GraphVectors.load(str(a))):
        assert rel(got.syn0, syn0) <= 1e-7
    gv = GraphVectors(torch.from_numpy(syn0))
    assert gv.similarity(1, 2) == pytest.approx(
        jax_dw.GraphVectors(syn0).similarity(1, 2), abs=1e-6)


def test_deepwalk_carried_from_the_reference_continues():
    gp, gj = both_graphs(120, planted_partition(120, 4, 8, 2, 10))
    j = jax_dw.DeepWalk(**DW_KW).fit(gj, walk_length=10)
    p = interop.embeddings_from_numpy(
        "deepwalk", {"syn0": np.asarray(j._syn0), "syn1": np.asarray(j._syn1)},
        degrees=gj.degrees(), walk_rng_state=j._walk_rng.get_state(),
        device="cpu", **DW_KW)
    assert p.vertices_nearest(0, 4).tolist() == \
        j.vertices_nearest(0, 4).tolist()
    p.fit(gp, walk_length=10)
    j.fit(gj, walk_length=10)
    assert rel(p.syn0, j.syn0) <= FIT_TOL
    assert rel(p._syn1, np.asarray(j._syn1)) <= FIT_TOL
    with pytest.raises(ValueError, match="degrees"):
        interop.embeddings_from_numpy("deepwalk", {}, device="cpu")
