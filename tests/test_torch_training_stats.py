"""Training statistics in the port's engines (`last_training_stats` under a
listener with `requires_training_stats`) against the JAX package's, on the
CPU, in float64 from the same params: every layer's and param's mean
|gradient|, |update| (bias-rate factor included) and |param| after each
step to 1e-10 relative; the params after a stats step equal a plain
step's bit for bit; the stats cleared by a solver fit; the superstep gated
off by such a listener."""

import numpy as np
import pytest

from conftest import make_classification_data
from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.conf.neural_net import NeuralNetConfiguration as JN
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

REF = dict(rtol=1e-10, atol=1e-14)


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


class Probe:
    """A listener that asks for the stats and keeps each step's."""

    requires_training_stats = True

    def __init__(self):
        self.seen = []

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def iteration_done(self, model, iteration):
        self.seen.append({lk: {k: {s: float(v) for s, v in d.items()}
                               for k, d in p.items()}
                          for lk, p in model.last_training_stats.items()})


def _conf(updater, **kw):
    b = (JN.builder().seed(5).updater(updater).learning_rate(0.05)
         .bias_learning_rate(0.1).weight_init("xavier").dtype("float64"))
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return (b.list()
            .layer(JL.DenseLayer(n_out=6, activation="tanh"))
            .layer(JL.BatchNormalization())
            .layer(JL.OutputLayer(n_out=3, activation="softmax",
                                  loss_function="mcxent"))
            .set_input_type(JInputType.feed_forward(4)).build())


def _nets(jconf, engine=MultiLayerNetwork, jengine=JaxMLN,
          conf_cls=MultiLayerConfiguration):
    jnet = jengine(jconf).init()
    pnet = engine(conf_cls.from_json(jconf.to_json()), device="cpu")
    pnet.init(params=interop.params_from_numpy(
        {v: {n: np.array(a) for n, a in p.items()}
         for v, p in jnet.params_tree.items()}))
    return jnet, pnet


def _batches(rng, n=3):
    return [make_classification_data(rng, n=8) for _ in range(n)]


def _compare(got, want):
    assert got.keys() == want.keys()
    for lk in want:
        assert got[lk].keys() == want[lk].keys()
        for pk in want[lk]:
            for s in ("grad_mm", "update_mm", "param_mm"):
                np.testing.assert_allclose(got[lk][pk][s], want[lk][pk][s],
                                           **REF)


@pytest.mark.parametrize("updater", ["adam", "nesterovs", "rmsprop", "sgd",
                                     "adagrad"])
def test_stats_match_the_reference(rng, updater):
    jnet, pnet = _nets(_conf(updater))
    jp, pp = Probe(), Probe()
    jnet.set_listeners(jp)
    pnet.set_listeners(pp)
    assert pnet._collect_stats and jnet._collect_stats
    for x, y in _batches(rng):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    assert len(pp.seen) == len(jp.seen) == 3
    for got, want in zip(pp.seen, jp.seen):
        _compare(got, want)
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **REF)


def test_stats_under_gradient_normalization_and_l2(rng):
    jnet, pnet = _nets(_conf("adam", l2=1e-2,
                             gradient_normalization="ClipL2PerLayer",
                             gradient_normalization_threshold=0.5))
    jp, pp = Probe(), Probe()
    jnet.set_listeners(jp)
    pnet.set_listeners(pp)
    for x, y in _batches(rng, 2):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    for got, want in zip(pp.seen, jp.seen):
        _compare(got, want)


@pytest.mark.parametrize("updater", ["adam", "nesterovs", "sgd"])
def test_a_stats_step_moves_the_params_as_a_plain_step(rng, updater):
    _, stats = _nets(_conf(updater))
    plain = MultiLayerNetwork(stats.conf, device="cpu").init(
        params=stats.params_tree)
    stats.set_listeners(Probe())
    for x, y in _batches(rng):
        stats.fit(DataSet(x, y))
        plain.fit(DataSet(x, y))
    np.testing.assert_array_equal(stats.params(), plain.params())
    np.testing.assert_array_equal(stats.updater_state_flat(),
                                  plain.updater_state_flat())


def test_graph_stats_match_the_reference(rng):
    gb = (JN.builder().seed(5).updater("adam").learning_rate(0.05)
          .weight_init("xavier").dtype("float64").graph_builder()
          .add_inputs("in")
          .add_layer("d", JL.DenseLayer(n_out=6, activation="tanh"), "in")
          .add_layer("out", JL.OutputLayer(n_out=3, activation="softmax",
                                           loss_function="mcxent"), "d")
          .set_outputs("out").set_input_types(JInputType.feed_forward(4)))
    jnet, pnet = _nets(gb.build(), ComputationGraph, JaxCG,
                       ComputationGraphConfiguration)
    jp, pp = Probe(), Probe()
    jnet.set_listeners(jp)
    pnet.set_listeners(pp)
    for x, y in _batches(rng, 2):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    for got, want in zip(pp.seen, jp.seen):
        _compare(got, want)


def test_a_solver_clears_the_stats_and_a_listener_gates_the_superstep(rng):
    _, pnet = _nets(_conf("adam", superstep_k=4))
    pnet.set_listeners(Probe())
    assert pnet._superstep_k() == 0
    x, y = _batches(rng, 1)[0]
    pnet.fit(DataSet(x, y))
    assert pnet.last_training_stats
    pnet.conf.global_conf.optimization_algo = "lbfgs"
    pnet.fit(DataSet(x, y))
    assert pnet.last_training_stats == {}
    pnet.set_listeners()
    assert not pnet._collect_stats
