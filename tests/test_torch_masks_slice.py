"""Features masks in the port against the JAX package, on the CPU: masked
dense attention, masks carried through both engines, their preprocessors
and vertices (`LastTimeStep`, `ReverseTimeSeries`), an output's features
mask as its loss mask, and `zoo.transformer_classifier` on ragged batches
(`examples/text_classifier.py`'s size: V=40, T=24, d=32, 4 heads, 2
blocks) through `output`, `fit`, `score` and `evaluate`.

Inputs and params from seeded numpy, f32. Tolerances: attention and
`output` rtol = atol = 1e-5; `fit` steps rtol 2e-4, atol 1e-5 (as the
earlier training slices), Adam m atol 1e-6; the padding check bit for
bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import graph as jax_graph
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import attention as jax_attention
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf import graph
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import attention
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=2e-4, atol=1e-5)
M_TOL = dict(rtol=2e-4, atol=1e-6)
V, T, C = 40, 24, 3


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


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {k: ({f: {n: np.array(a) for n, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {n: np.array(a) for n, a in p.items()})
            for k, p in tree.items() if isinstance(p, dict)}


def _ragged(n, seed, t=T):
    """The example's batches: class-marker tokens in ragged sequences,
    padding id 0, sparse int labels, a [n, t] mask."""
    r = np.random.RandomState(seed)
    cls = r.randint(0, C, n)
    lens = r.randint(8, t + 1, n)
    lens[0] = t
    idx = r.randint(0, V, (n, t))
    mask = np.zeros((n, t), np.float32)
    for i in range(n):
        mask[i, :lens[i]] = 1.0
        sel = r.rand(lens[i]) < 0.5
        idx[i, :lens[i]][sel] = cls[i]
        idx[i, lens[i]:] = 0
    return idx, cls.astype(np.int32), mask


def _classifiers():
    kw = dict(t=T, d_model=32, n_heads=4, n_blocks=2, lr=5e-3)
    jnet = JaxGraph(jax_zoo.transformer_classifier(V, C, **kw)).init()
    pnet = ComputationGraph(zoo.transformer_classifier(V, C, **kw),
                            device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_masked_dense_attention_is_the_references(causal):
    r = np.random.RandomState(1)
    q, k, v = (r.randn(3, 7, 2, 4).astype(np.float32) for _ in range(3))
    mask = (r.rand(3, 7) < 0.7).astype(np.float32)
    mask[1] = 0.0  # a fully masked row gives zeros
    want = jax_attention._masked_dense_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask), causal,
        0.5)
    got = attention._masked_dense_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
        causal, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    assert not got[1].any()


def test_a_masked_batch_runs_dense_and_an_unmasked_one_flash():
    _, pnet = _classifiers()
    idx, _, mask = _ragged(4, 3)
    kernels.reset_counts()
    pnet.output(idx, features_masks=[mask])
    assert kernels.counts()["plain_calls"]["flash_attention"] == 0
    pnet.output(idx)
    assert kernels.counts()["plain_calls"]["flash_attention"] == 2


# -------------------------------------------------------------- classifier

def test_classifier_masked_output_is_the_references():
    jnet, pnet = _classifiers()
    idx, _, mask = _ragged(6, 0)
    want = jnet.output(idx.astype(np.float32), features_masks=[mask])[0]
    got = pnet.output(idx, features_masks=[mask])[0]
    np.testing.assert_allclose(got, np.asarray(want), **FWD)
    # The masks change the answer for the ragged rows only.
    plain = pnet.output(idx)[0]
    np.testing.assert_allclose(plain[0], got[0], **FWD)
    assert not np.allclose(plain[1:], got[1:], **FWD)


def test_classifier_padding_does_not_leak():
    _, pnet = _classifiers()
    idx, _, mask = _ragged(6, 1)
    other = np.where(mask > 0, idx, (idx + 7) % V)
    assert (other != idx).any()
    np.testing.assert_array_equal(pnet.output(other, features_masks=[mask]),
                                  pnet.output(idx, features_masks=[mask]))


def test_classifier_fit_steps_are_the_references():
    jnet, pnet = _classifiers()
    for step in range(2):
        idx, cls, mask = _ragged(8, 10 + step)
        jnet.fit(JaxMDS([idx.astype(np.float32)], [cls],
                        features_masks=[mask]))
        pnet.fit(MultiDataSet([idx], [cls], features_masks=[mask]))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)
    jm = _np_tree({v: s["m"] for v, s in jnet.opt_state.items()
                   if isinstance(s, dict) and "m" in s})
    for v, m in jm.items():
        for n, a in m.items():
            np.testing.assert_allclose(pnet.opt_state[v]["m"][n].numpy(), a,
                                       err_msg=f"{v}/{n}", **M_TOL)
    for v, p in _np_tree(jnet.params_tree).items():
        for n, a in p.items():
            np.testing.assert_allclose(pnet.params_tree[v][n].detach()
                                       .numpy(), a, err_msg=f"{v}/{n}",
                                       **STEP)


def test_classifier_score_and_evaluate_with_masks():
    jnet, pnet = _classifiers()
    idx, cls, mask = _ragged(8, 20)
    jmds = JaxMDS([idx.astype(np.float32)], [cls], features_masks=[mask])
    pmds = MultiDataSet([idx], [cls], features_masks=[mask])
    np.testing.assert_allclose(pnet.score(pmds), jnet.score(jmds), **STEP)
    assert pnet.score(pmds) != pytest.approx(pnet.score(MultiDataSet(
        [idx], [cls])), rel=1e-4)
    want, got = jnet.evaluate(jmds), pnet.evaluate(pmds)
    out = pnet.output(idx, features_masks=[mask])[0]
    top2 = np.sort(out, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 1e-4  # no near-tie
    assert got.accuracy() == want.accuracy()
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)


# ----------------------------------------------------- vertices and engines

def test_last_time_step_takes_the_last_unmasked_step():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                        dtype=torch.float32)
    v = graph.LastTimeStepVertex()
    got = v.apply([x], [mask])
    assert torch.equal(got[0], x[0, 2]) and torch.equal(got[1], x[1, 4])
    assert torch.equal(v.apply([x]), x[:, -1])
    rev = graph.ReverseTimeSeriesVertex().apply([x], [mask])
    assert torch.equal(rev[0, :3], x[0, :3].flip(0))
    assert torch.equal(rev[0, 3:], x[0, 3:])
    assert torch.equal(rev[1], x[1].flip(0))


def _vertex_graph(builder, L, G, input_type, kind):
    gb = (builder().seed(4).learning_rate(0.05).updater("adam")
          .graph_builder().add_inputs("in"))
    if kind == "reverse":
        gb.add_vertex("rev", G.ReverseTimeSeriesVertex(), "in")
        gb.add_layer("lstm", L.GravesLSTM(n_out=5), "rev")
        gb.add_layer("pool", L.GlobalPoolingLayer(pooling_type="max"),
                     "lstm")
        last = "pool"
    else:
        gb.add_layer("lstm", L.GravesLSTM(n_out=5), "in")
        gb.add_vertex("last", G.LastTimeStepVertex(
            mask_array_input="in" if kind == "mask_input" else None),
            "lstm")
        last = "last"
    gb.add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                      loss_function="mcxent"), last)
    return (gb.set_outputs("out")
            .set_input_types(input_type.recurrent(4, 6)).build())


@pytest.mark.parametrize("kind", ["last_step", "mask_input", "reverse"])
def test_vertices_under_masks_are_the_references(kind):
    jnet = JaxGraph(_vertex_graph(JaxNNC.builder, jax_layers, jax_graph,
                                  JaxInputType, kind)).init()
    pnet = ComputationGraph(_vertex_graph(
        NeuralNetConfiguration.builder, layers, graph, InputType, kind),
        device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    r = np.random.RandomState(7)
    x = r.randn(4, 6, 4).astype(np.float32)
    mask = np.ones((4, 6), np.float32)
    mask[1, 3:] = 0.0
    mask[2, 1:] = 0.0
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 4)]
    want = jnet.output(x, features_masks=[mask])[0]
    got = pnet.output(x, features_masks=[mask])[0]
    np.testing.assert_allclose(got, np.asarray(want), **FWD)
    assert not np.allclose(got, pnet.output(x)[0], **FWD)
    for _ in range(2):
        jnet.fit(JaxMDS([x], [y], features_masks=[mask]))
        pnet.fit(MultiDataSet([x], [y], features_masks=[mask]))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)


def _mln_pool(builder, L, input_type):
    return (builder().seed(9).learning_rate(0.05).updater("adam").list()
            .layer(L.GravesLSTM(n_out=6))
            .layer(L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(input_type.recurrent(4, 7)).build())


def test_mln_masked_pooling_is_the_references():
    jnet = JaxMLN(_mln_pool(JaxNNC.builder, jax_layers, JaxInputType)).init()
    pnet = MultiLayerNetwork(_mln_pool(NeuralNetConfiguration.builder,
                                       layers, InputType), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    r = np.random.RandomState(8)
    x = r.randn(5, 7, 4).astype(np.float32)
    mask = (r.rand(5, 7) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, 5)]
    np.testing.assert_allclose(pnet.output(x, features_mask=mask),
                               np.asarray(jnet.output(x, features_mask=mask)),
                               **FWD)
    np.testing.assert_allclose(
        pnet.score(DataSet(x, y, features_mask=mask)),
        jnet.score(JaxDataSet(x, y, features_mask=mask)), **STEP)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y, features_mask=mask))
        pnet.fit(DataSet(x, y, features_mask=mask))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)


def _seq_graph(builder, L, input_type):
    return (builder().seed(2).learning_rate(0.05).updater("adam")
            .graph_builder().add_inputs("in")
            .add_layer("lstm", L.GravesLSTM(n_out=5), "in")
            .add_layer("out", L.RnnOutputLayer(n_out=3, activation="softmax",
                                               loss_function="mcxent"),
                       "lstm")
            .set_outputs("out")
            .set_input_types(input_type.recurrent(4, 6)).build())


def test_a_sequence_output_takes_its_features_mask_as_loss_mask():
    jnet = JaxGraph(_seq_graph(JaxNNC.builder, jax_layers,
                               JaxInputType)).init()
    pnet = ComputationGraph(_seq_graph(NeuralNetConfiguration.builder,
                                       layers, InputType), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    r = np.random.RandomState(12)
    x = r.randn(3, 6, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.randint(0, 3, (3, 6))]
    mask = np.ones((3, 6), np.float32)
    mask[0, 2:] = 0.0
    masked = pnet.score(MultiDataSet([x], [y], features_masks=[mask]))
    np.testing.assert_allclose(
        masked, jnet.score(JaxMDS([x], [y], features_masks=[mask])), **STEP)
    np.testing.assert_allclose(
        masked, pnet.score(MultiDataSet([x], [y], features_masks=[mask],
                                        labels_masks=[mask])), **STEP)
