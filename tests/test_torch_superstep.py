"""Superstep training in the port (`engine.py` `_fit_superstep`, and
`nn/superstep.py` on the card) against the JAX package's, on the CPU, where
the port runs a block's K steps in a loop: the reference's
`tests/test_superstep.py` cases that are not XLA's.

- The port's superstep equals its per-batch fit bit for bit (dropout, the
  BatchNorm running statistics, Adam, a masked loss, the tail block).
- Against the reference's superstep fit from the same params, without
  dropout (the two packages draw their masks from different generators):
  params, updater state, layer state and every score, in float64, to
  1e-10 relative.
- The gates (stats listener, `iterations > 1`, truncated BPTT, solvers),
  `DL4J_TPU_SUPERSTEP_K`, listener fan-out, JSON round trip, the wrapper
  cached on its iterator, ComputationGraph over MultiDataSets.
- What `nn/superstep.py` does on the card that runs here too: the step
  context the warm-up and the capture run under (each draw noted, and
  drawn from a generator seeded as a replay seeds it; a key derived on
  the host refused), and the graphs a net keeps (a full-K block's and a
  tail's, each captured once over many epochs).
"""

import numpy as np
import pytest
import torch

from conftest import make_classification_data
from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.neural_net import NeuralNetConfiguration as JN
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DeviceCacheDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.datasets.iterators import Superbatch
from deeplearning4j_tpu_torch.nn import superstep
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import common
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.prng import LayerKey, split
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
    IterationListener,
)

N_IN, N_OUT = 4, 3
REF = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    tests/test_torch_rnn_slice.py)."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def mlp_conf(nn, Ls, it, k=0, dropout=True, bn=True, dtype="float32", **g):
    b = (nn.builder().seed(7).learning_rate(0.05).updater("adam")
         .weight_init("xavier").superstep_k(k).dtype(dtype))
    for name, v in g.items():
        b = getattr(b, name)(v)
    lb = b.list().layer(Ls.DenseLayer(n_out=8, activation="relu"))
    if bn:
        lb = lb.layer(Ls.BatchNormalization())
    if dropout:
        lb = lb.layer(Ls.DropoutLayer(dropout=0.5))
    lb = lb.layer(Ls.OutputLayer(n_out=N_OUT, activation="softmax",
                                 loss_function="mcxent"))
    return lb.set_input_type(it.feed_forward(N_IN)).build()


def port_mlp(k=0, **kw):
    return MultiLayerNetwork(mlp_conf(NeuralNetConfiguration, L, InputType,
                                      k, **kw), device="cpu").init()


def make_batches(rng, n_batches=7, batch=6, labels_mask=False,
                 dtype="float32"):
    out = []
    for _ in range(n_batches):
        x, y = make_classification_data(rng, n=batch, n_features=N_IN,
                                        n_classes=N_OUT, dtype=dtype)
        lm = None
        if labels_mask:
            lm = (rng.rand(batch) < 0.7).astype(dtype)
            lm[0] = 1.0
        out.append((x, y, lm))
    return out


def _ds(batches):
    return [DataSet(x, y, None, lm) for x, y, lm in batches]


def _snapshot(net):
    return (net.params(), net.updater_state_flat(),
            {lk: {k: t.detach().clone() for k, t in s.items()}
             for lk, s in net.state.items()})


def _identical(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2].keys() == b[2].keys()
    for lk in a[2]:
        for k in a[2][lk]:
            np.testing.assert_array_equal(a[2][lk][k].numpy(),
                                          b[2][lk][k].numpy())


@pytest.mark.parametrize("k,n,masked", [(4, 7, False), (3, 6, True),
                                        (2, 5, False), (8, 3, False)])
def test_superstep_equals_per_batch_bit_for_bit(rng, k, n, masked):
    batches = _ds(make_batches(rng, n_batches=n, labels_mask=masked))
    ref = port_mlp(0)
    ref.set_listeners(CollectScoresIterationListener())
    for ds in batches:
        ref.fit(ds)
    net = port_mlp(k)
    net.set_listeners(CollectScoresIterationListener())
    net.fit(batches)
    _identical(_snapshot(ref), _snapshot(net))
    assert ref.iteration == net.iteration == n
    assert ref.listeners[0].scores == net.listeners[0].scores
    np.testing.assert_array_equal(ref._train_rng, net._train_rng)


def _pair(k, batches, graph=False):
    """The reference's and the port's superstep fits from the same params,
    float64, no dropout; (jax net, port net)."""
    if graph:
        jconf = graph_conf(JN, JL, JInputType, k, dropout=False)
        jnet = JaxCG(jconf).init()
        pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            jconf.to_json()), device="cpu")
    else:
        jconf = mlp_conf(JN, JL, JInputType, k, dropout=False,
                         dtype="float64")
        jnet = JaxMLN(jconf).init()
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()), device="cpu")
    pnet.init(params=interop.params_from_numpy(
        {v: {n: np.array(a) for n, a in p.items()}
         for v, p in jnet.params_tree.items()}))
    jnet.set_listeners(JCollect())
    pnet.set_listeners(CollectScoresIterationListener())
    return jnet, pnet


@pytest.mark.parametrize("k,n", [(4, 7), (3, 6), (2, 2)])
def test_superstep_matches_the_references(rng, k, n):
    raw = make_batches(rng, n_batches=n, labels_mask=True, dtype="float64")
    jnet, pnet = _pair(k, raw)
    jnet.fit([JDataSet(x, y, None, lm) for x, y, lm in raw])
    pnet.fit(_ds(raw))
    assert pnet.iteration == jnet.iteration == n
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **REF)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **REF)
    for lk, s in jnet.state.items():
        for key, a in s.items():
            np.testing.assert_allclose(pnet.state[lk][key].numpy(),
                                       np.asarray(a), **REF)
    js = [s for _, s in jnet.listeners[0].scores]
    ps = [s for _, s in pnet.listeners[0].scores]
    np.testing.assert_allclose(ps, js, **REF)


def test_env_knob_overrides_the_conf(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SUPERSTEP_K", "3")
    assert port_mlp(0)._superstep_k() == 3
    monkeypatch.setenv("DL4J_TPU_SUPERSTEP_K", "0")
    net = port_mlp(8)
    assert net._superstep_k() == 0
    monkeypatch.setenv("DL4J_TPU_SUPERSTEP_K", "junk")
    assert net._superstep_k() == 0
    monkeypatch.delenv("DL4J_TPU_SUPERSTEP_K")
    assert net._superstep_k() == 8


@pytest.mark.parametrize("gate", ["iterations", "lbfgs", "tbptt", "stats"])
def test_gates_force_per_batch(gate):
    kw = {"iterations": dict(iterations=3),
          "lbfgs": dict(dropout=False, bn=False, optimization_algo="lbfgs"),
          "tbptt": {}, "stats": {}}[gate]
    net = port_mlp(8, **kw)
    if gate == "tbptt":
        net.conf.backprop_type = "truncatedbptt"
    if gate == "stats":
        class Stats(IterationListener):
            requires_training_stats = True
        net.set_listeners(Stats())
    assert net._superstep_k() == 0
    jkw = dict(kw)
    jnet = JaxMLN(mlp_conf(JN, JL, JInputType, 8, **jkw)).init()
    if gate == "tbptt":
        jnet.conf.backprop_type = "truncatedbptt"
    if gate == "stats":
        jnet._collect_stats = True
    assert jnet._superstep_k() == 0


def test_listener_fanout_order_and_scores(rng):
    batches = _ds(make_batches(rng, n_batches=5))

    def run(k):
        seen = []

        class Probe(IterationListener):
            def iteration_done(self, model, iteration):
                seen.append((iteration, float(model.score_value)))

        collect = CollectScoresIterationListener(frequency=1)
        net = port_mlp(k)
        net.set_listeners(Probe(), collect)
        net.fit(batches)
        return seen, collect.scores

    seq_seen, seq_scores = run(0)
    sup_seen, sup_scores = run(3)
    assert [i for i, _ in sup_seen] == [1, 2, 3, 4, 5]
    assert sup_seen == seq_seen and sup_scores == seq_scores


def test_a_stats_listener_trains_per_batch_and_collects(rng):
    class Stats(IterationListener):
        requires_training_stats = True

    net = port_mlp(4)
    net.set_listeners(Stats())
    net.fit(_ds(make_batches(rng, n_batches=4)))
    assert net.iteration == 4 and net.last_training_stats
    assert "_superstep_blocks" not in net.__dict__


def test_superstep_k_survives_the_json_round_trip():
    conf = mlp_conf(NeuralNetConfiguration, L, InputType, 6)
    restored = MultiLayerConfiguration.from_json(conf.to_json())
    assert restored.global_conf.superstep_k == 6
    jconf = mlp_conf(JN, JL, JInputType, 6)
    assert conf.to_json() == jconf.to_json()


def test_the_wrapper_is_cached_on_its_iterator(rng):
    net = port_mlp(2)
    base = DeviceCacheDataSetIterator(_ds(make_batches(rng, n_batches=4)),
                                      device="cpu")
    w1 = net._superstep_wrap(base, 2)
    assert net._superstep_wrap(base, 2) is w1
    assert net._superstep_wrap(base, 3) is not w1
    assert net._superstep_wrap(w1, 2) is w1
    lst = _ds(make_batches(rng, n_batches=2))
    assert net._superstep_wrap(lst, 2).base is lst


def test_a_device_cache_epoch_trains_as_the_per_batch_loop(rng):
    raw = make_batches(rng, n_batches=6)
    ref = port_mlp(0)
    net = port_mlp(4)
    for _ in range(2):
        for ds in _ds(raw):
            ref.fit(ds)
    cache = DeviceCacheDataSetIterator(_ds(raw), device="cpu")
    for _ in range(2):
        net.fit(cache)
    _identical(_snapshot(ref), _snapshot(net))
    assert net.iteration == 12


def graph_conf(nn, Ls, it, k=0, dropout=True):
    gb = (nn.builder().seed(7).learning_rate(0.05).updater("adam")
          .weight_init("xavier").superstep_k(k).dtype("float64")
          .graph_builder().add_inputs("in")
          .add_layer("d", Ls.DenseLayer(n_out=8, activation="relu"), "in"))
    last = "d"
    if dropout:
        gb = gb.add_layer("drop", Ls.DropoutLayer(dropout=0.4), "d")
        last = "drop"
    return (gb.add_layer("out", Ls.OutputLayer(
        n_out=N_OUT, activation="softmax", loss_function="mcxent"), last)
            .set_outputs("out").set_input_types(it.feed_forward(N_IN))
            .build())


@pytest.mark.parametrize("k,n", [(3, 5), (2, 4)])
def test_graph_superstep_over_multidatasets(rng, k, n):
    raw = make_batches(rng, n_batches=n, batch=5, dtype="float64")
    mds = [MultiDataSet([x], [y]) for x, y, _ in raw]
    ref = ComputationGraph(graph_conf(NeuralNetConfiguration, L, InputType),
                           device="cpu").init()
    for m in mds:
        ref.fit(m)
    net = ComputationGraph(graph_conf(NeuralNetConfiguration, L, InputType,
                                      k), device="cpu").init()
    net.fit(mds)
    np.testing.assert_array_equal(net.params(), ref.params())
    assert net.iteration == ref.iteration == n
    jnet, pnet = _pair(k, raw, graph=True)
    jnet.fit([JMultiDataSet([x], [y]) for x, y, _ in raw])
    pnet.fit([MultiDataSet([x], [y]) for x, y, _ in raw])
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **REF)


# ------------------------------------------- the capture's step context

def _step_under(net, ctx, ds):
    net._step_ctx = ctx
    try:
        net._sgd_step(ds)
    finally:
        net._step_ctx = None


def test_a_warm_up_context_notes_each_draw_and_leaves_the_step_as_it_was(
        rng):
    # The card's warm-up step runs under this context: the engine wraps the
    # step key, the dropout draw (layer 2) is noted and takes a fresh
    # generator, so the step is the plain one.
    ds = _ds(make_batches(rng, n_batches=1))[0]
    ref, net = port_mlp(0), port_mlp(0)
    ref._sgd_step(ds)
    ctx = superstep._StepContext()
    _step_under(net, ctx, ds)
    _identical(_snapshot(ref), _snapshot(net))
    assert ctx.draws == [(None, 0, 2, ())]
    assert ctx.steps == 1 and ctx.refused is None


def test_a_capture_context_draws_as_a_replay_seeds_it(rng):
    # Under capture each draw takes the next registered generator; seeded
    # from the step's key as `_replay` seeds it, the step is the plain one
    # (and with a generator seeded otherwise it is not).
    ds = _ds(make_batches(rng, n_batches=1))[0]
    ref = port_mlp(0)
    ref._sgd_step(ds)
    for seeded in (True, False):
        net = port_mlp(0)
        gen = torch.Generator()
        if seeded:
            sub = split(net._train_rng)[1]
            w0, w1 = (int(w) for w in LayerKey(sub, 2).words)
            gen.manual_seed((w0 << 32) | w1)
        ctx = superstep._StepContext(gens=[gen])
        _step_under(net, ctx, ds)
        assert ctx.draws == [(gen, 0, 2, ())]
        assert np.array_equal(ref.params(), net.params()) == seeded


def test_a_draw_no_replay_could_seed_is_refused():
    words = np.array([1, 2], np.uint32)
    warm = superstep._StepContext()
    common.key_words(LayerKey(warm.step_key(words), 3))
    assert warm.refused == "a draw from a key derived on the host"
    cap = superstep._StepContext(gens=[torch.Generator()])
    with pytest.raises(superstep._Uncapturable):
        common.key_words(LayerKey(cap.step_key(words), 3))
    with pytest.raises(superstep._Uncapturable):
        common.draw_keep(cap.step_key(words), 0.5, (2,), "cpu")
    common.draw_keep(LayerKey(cap.step_key(words), 0), 0.5, (2,), "cpu")
    with pytest.raises(superstep._Uncapturable):  # more than the warm-up
        common.draw_keep(LayerKey(cap.step_key(words), 0), 0.5, (2,), "cpu")
    assert [d[1:] for d in cap.draws] == [(2, 0, ())]  # the third key


def test_a_net_keeps_a_full_block_graph_and_a_tail_graph(monkeypatch):
    # Three epochs of 11 batches at K = 4 (two blocks and a tail of 3):
    # two captures in all. A further signature drops the graph used
    # longest ago; its counts stay, and join those of a later capture of
    # its signature when that one is dropped too.
    made = []

    def capture(net, sb):
        made.append(sb.k)
        return superstep._Block(object(), [], [0.0] * sb.k, [], None, {}, 0)

    def replay(net, blk, sb):
        blk.replays += 1
        return []
    monkeypatch.setattr(superstep, "_capture", capture)
    monkeypatch.setattr(superstep, "_replay", replay)

    def block(k, b=16):
        return Superbatch(torch.zeros(k, b, N_IN), torch.zeros(k, b, N_OUT),
                          k=k)
    net = port_mlp(0)
    for _ in range(3):
        for k in (4, 4, 3):
            superstep.run(net, block(k))
    assert made == [4, 3]
    assert [(b.k, b.captures, b.replays)
            for b in superstep.captured(net)] == [(4, 1, 6), (3, 1, 3)]
    # Another batch size (drops the K = 4 graph), the K = 4 block again
    # (drops the tail's), the tail, and the other size again (drops the
    # second K = 4 graph, whose counts join the first's).
    for k, b in ((4, 8), (4, 16), (3, 16), (4, 8)):
        superstep.run(net, block(k, b))
    assert made == [4, 3, 4, 4, 3, 4]
    done = list(net._superstep_done.values())
    assert all(b.graph is None and b.draws is None for b in done)
    assert [(b.k, b.captures, b.replays) for b in done] == [
        (4, 2, 7), (3, 1, 3), (4, 1, 1)]
    assert len(net._superstep_blocks) == superstep.KEEP
