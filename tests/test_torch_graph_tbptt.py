"""Truncated BPTT on the port's `ComputationGraph` against the JAX package,
on the CPU.

The graphs are built with each package's own `graph_builder()` (their JSON
must agree), the JAX net's params carried over as numpy, and both nets fed
the same seeded batches:

- the sequence + static two-input graph of `tests/test_multilayer.py`
  (a GravesLSTM on the sequence, a dense layer on a static [b, 5] input
  whose width must not be mistaken for time) with a labels mask;
- the character graph of dl4j-examples' `CompGraphLSTMExample` at small
  widths (two GravesLSTMs, the second fed by the input and the first, the
  output by both), one-hot labels and [b, t] integer class ids;
- a ragged last chunk (T = 14 in chunks of 4).

Tolerances: f32 scores and updater state rtol 2e-4, atol 2e-5, as the
earlier training slices (the same ops, sums in another order); params
rtol 2e-4, atol 1e-4, as `tests/test_torch_rnn_slice.py` holds the
char-RNN's: RMSProp's step lr * g / sqrt(g2 + eps) moves a param whose
|g| is near sqrt(eps / (1 - decay)) by about lr / sqrt(eps) = 1000 times
its gradient's rounding error. The iteration and the train key's
continuation are equal, and the carried h and c are gone after `fit`.

Both packages read only the first input of a layer vertex given several
(DL4J's builder would insert a MergeVertex): the character graph names its
MergeVertex vertices explicitly.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import graph as jax_graph
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    ComputationGraphConfiguration as JaxGraphConf,
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import prng
from deeplearning4j_tpu_torch.nn.conf import graph, layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

F32 = dict(rtol=2e-4, atol=2e-5)
PARAMS = dict(rtol=2e-4, atol=1e-4)
N, V, B, FWD = 8, 9, 3, 4


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


def _assert_trees(port_tree, jax_tree, what, tol=F32):
    for k, p in jax_tree.items():
        for n, a in p.items():
            if isinstance(a, dict):
                _assert_trees({n: port_tree[k][n]}, {n: a}, f"{what} {k}",
                              tol)
                continue
            np.testing.assert_allclose(
                port_tree[k][n].detach().float().numpy(), a,
                err_msg=f"{what} {k}/{n}", **tol)


def two_input_conf(builder, L, IT, G, fwd=FWD):
    """The seq + static graph (tests/test_multilayer.py:299-320)."""
    gb = (builder().seed(11).learning_rate(0.05).updater("nesterovs")
          .weight_init("xavier").graph_builder()
          .add_inputs("seq", "static")
          .add_layer("lstm", L.GravesLSTM(n_out=N, activation="tanh"),
                     "seq")
          .add_layer("emb", L.DenseLayer(n_out=N, activation="tanh"),
                     "static")
          .add_layer("out", L.RnnOutputLayer(n_out=3, activation="softmax",
                                             loss_function="mcxent"),
                     "lstm")
          .set_outputs("out")
          .backprop_type("truncatedbptt").t_bptt_forward_length(fwd)
          .t_bptt_backward_length(fwd))
    gb.set_input_types(IT.recurrent(3), IT.feed_forward(5))
    return gb.build()


def char_graph_conf(builder, L, IT, G, n=N, vocab=V, fwd=FWD, lr=0.1):
    """dl4j-examples' CompGraphLSTMExample: input -> first; (input, first)
    -> second; (first, second) -> out, each pair through a MergeVertex (G
    the package's graph-vertex module: a layer vertex reads only its first
    input in both packages, where DL4J's builder inserts the merge);
    RMSProp (decay 0.95), l2 1e-3, xavier, tBPTT fwd = back."""
    gb = (builder().seed(12345).learning_rate(lr).updater("rmsprop")
          .rms_decay(0.95).l2(0.001).regularization(True)
          .weight_init("xavier").graph_builder()
          .add_inputs("input")
          .add_layer("first", L.GravesLSTM(n_out=n, activation="tanh"),
                     "input")
          .add_vertex("first_in", G.MergeVertex(), "input", "first")
          .add_layer("second", L.GravesLSTM(n_out=n, activation="tanh"),
                     "first_in")
          .add_vertex("out_in", G.MergeVertex(), "first", "second")
          .add_layer("out", L.RnnOutputLayer(n_out=vocab,
                                             activation="softmax",
                                             loss_function="mcxent"),
                     "out_in")
          .set_outputs("out")
          .backprop_type("truncatedbptt").t_bptt_forward_length(fwd)
          .t_bptt_backward_length(fwd))
    gb.set_input_types(IT.recurrent(vocab))
    return gb.build()


def _confs(fn, **kw):
    jconf = fn(JaxNNC.builder, jax_layers, JaxInputType, jax_graph, **kw)
    pconf = fn(NeuralNetConfiguration.builder, layers, InputType, graph,
               **kw)
    return jconf, pconf


def _nets(fn, **kw):
    jconf, pconf = _confs(fn, **kw)
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


def _char_batch(seed, t, b=B, sparse=False):
    ids = np.random.RandomState(seed).randint(0, V, (b, t + 1))
    x = np.eye(V, dtype=np.float32)[ids[:, :-1]]
    y = (ids[:, 1:].astype(np.int32) if sparse
         else np.eye(V, dtype=np.float32)[ids[:, 1:]])
    return x, y


def _fit_both(jnet, pnet, batches):
    """Fit each batch on both nets; after each call, the scores, params
    and updater state agree."""
    for i, kw in enumerate(batches):
        jnet.fit(JaxMDS(**kw))
        pnet.fit(MultiDataSet(**kw))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   err_msg=f"score {i}", **F32)
        _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree),
                      f"params after call {i}", PARAMS)
        _assert_trees(pnet.opt_state, _np_tree(jnet.opt_state),
                      f"updater state after call {i}")
    assert pnet.iteration == jnet.iteration == len(batches)
    want_key = np.asarray(jnet._clock[1] if jnet._clock is not None
                          else jnet._train_rng)
    np.testing.assert_array_equal(pnet._train_rng, want_key)
    # The carries are gone: no layer state is declared in these graphs.
    assert pnet.state == {}


# ------------------------------------------------------------- the conf

@pytest.mark.parametrize("fn", [two_input_conf, char_graph_conf])
def test_graph_builder_tbptt_round_trips(fn):
    jconf, pconf = _confs(fn)
    assert (pconf.backprop_type, pconf.tbptt_fwd_length,
            pconf.tbptt_back_length) == ("truncatedbptt", FWD, FWD)
    assert json.loads(pconf.to_json()) == json.loads(jconf.to_json())
    back = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert back.to_json() == pconf.to_json()
    jback = JaxGraphConf.from_json(pconf.to_json())
    assert jback.tbptt_fwd_length == FWD
    assert json.loads(jback.to_json()) == json.loads(jconf.to_json())


# ---------------------------------------------------------- the training

def test_two_input_graph_with_labels_mask_matches_jax():
    # T = 12 in chunks of 4; the static [b, 5] input passes every chunk
    # whole; the labels mask cuts row 0 at step 9, and the divisor is the
    # whole sequence's rows.
    jnet, pnet = _nets(two_input_conf)
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        x = rng.randn(B, 12, 3).astype(np.float32)
        s = rng.randn(B, 5).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (B, 12))]
        lmask = np.ones((B, 12), np.float32)
        lmask[0, 9:] = 0.0
        batches.append(dict(features=[x, s], labels=[y],
                            labels_masks=[lmask]))
    kernels.reset_counts()
    _fit_both(jnet, pnet, batches)
    # Three chunks a call, one update of the three layers each.
    assert kernels.counts()["plain_calls"]["lstm_cell"] == 2 * 12
    assert kernels.counts()["plain_calls"]["fused_update"] == 2 * 3 * 3


@pytest.mark.parametrize("sparse", [False, True], ids=["onehot", "int_ids"])
@pytest.mark.parametrize("t", [12, 14], ids=["even", "ragged"])
def test_char_graph_matches_jax(sparse, t):
    jnet, pnet = _nets(char_graph_conf)
    batches = [dict(zip(("features", "labels"),
                        ([a] for a in _char_batch(20 + i, t, sparse=sparse))))
               for i in range(2)]
    _fit_both(jnet, pnet, batches)


def test_char_graph_rnn_time_step_equals_output():
    # After training, stepping the graph one character at a time through
    # `rnn_time_step` gives `output` over the whole sequence, and so does
    # the reference's.
    jnet, pnet = _nets(char_graph_conf)
    x, y = _char_batch(5, 12)
    pnet.fit(MultiDataSet([x], [y]))
    jnet.fit(JaxMDS([x], [y]))
    full = pnet.output(x)[0]
    steps = np.stack([pnet.rnn_time_step(x[:, s])[0] for s in range(12)], 1)
    np.testing.assert_allclose(steps, full, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(full, np.asarray(jnet.output(x)[0]), **F32)


def test_short_sequence_takes_one_step():
    # A sequence no longer than a chunk is one ordinary step (the
    # reference's dispatch), and so is a net without tBPTT.
    jnet, pnet = _nets(char_graph_conf)
    x, y = _char_batch(6, FWD)
    key = pnet._train_rng.copy()
    kernels.reset_counts()
    _fit_both(jnet, pnet, [dict(features=[x], labels=[y])])
    assert kernels.counts()["plain_calls"]["fused_update"] == 3
    np.testing.assert_array_equal(pnet._train_rng, prng.split(key)[0])


def test_key_splits_once_a_chunk_and_listeners_once_a_sequence():
    _, pnet = _nets(char_graph_conf)
    seen = []

    class Listener:
        def on_epoch_start(self, net):
            pass

        def on_epoch_end(self, net):
            pass

        def iteration_done(self, net, iteration):
            seen.append(iteration)

    pnet.set_listeners(Listener())
    key = pnet._train_rng.copy()
    x, y = _char_batch(7, 14)  # chunks 4, 4, 4, 2
    pnet.fit(MultiDataSet([x], [y]))
    for _ in range(4):
        key = prng.split(key)[0]
    np.testing.assert_array_equal(pnet._train_rng, key)
    assert seen == [1] and pnet.iteration == 1


def test_transformer_lm_tbptt_matches_jax():
    # A graph with no recurrent layer: four chunks of 4 tokens, each its
    # own step from the same params (no carry); int32 labels.
    kw = dict(t=16, d_model=16, n_heads=2, n_blocks=1)
    jconf = jax_zoo.transformer_lm(V, **kw)
    jconf.backprop_type = "truncatedbptt"
    jconf.tbptt_fwd_length = 4
    pconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    ids = np.random.RandomState(9).randint(0, V, (2, 17))
    x, y = ids[:, :-1, None].astype(np.float32), ids[:, 1:].astype(np.int32)
    _fit_both(jnet, pnet, [dict(features=[x], labels=[y])])


def test_tbptt_refuses_a_decode_cache_in_both_packages():
    kw = dict(t=16, d_model=16, n_heads=2, n_blocks=1,
              decode_cache_length=16)
    jconf = jax_zoo.transformer_lm(V, **kw)
    pconf = zoo.transformer_lm(V, **kw)
    x = np.zeros((1, 16, 1), np.float32)
    y = np.zeros((1, 16), np.int32)
    for conf in (jconf, pconf):
        conf.backprop_type = "truncatedbptt"
        conf.tbptt_fwd_length = 4
    with pytest.raises(ValueError, match="decode_cache_length"):
        JaxGraph(jconf).init().fit(JaxMDS([x], [y]))
    net = ComputationGraph(pconf, device="cpu").init()
    with pytest.raises(ValueError, match="decode_cache_length"):
        net.fit(MultiDataSet([x], [y]))
    assert net.iteration == 0


def test_tbptt_refuses_labels_without_time():
    _, pnet = _nets(char_graph_conf)
    x, _ = _char_batch(8, 12)
    y = np.eye(V, dtype=np.float32)[np.zeros(B, int)]
    with pytest.raises(ValueError, match="per-timestep labels"):
        pnet.fit(MultiDataSet([x], [y]))
