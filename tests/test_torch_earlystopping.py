"""Early stopping of the port (`earlystopping/`) against the JAX package's,
on the CPU: the trainer's result (epochs, termination, the score of every
evaluated epoch, the best epoch and model) on the same data from the same
params, the eight termination conditions on the same score sequences, the
score calculator, and both savers' formats, each read by the other
package.

Small sizes: an MLP 4-16-3 (and a two-vertex graph) on 64 seeded examples
of three classes in batches of 16; scores at rtol 2e-4, the training
tolerance of the other slices.
"""

import os

import numpy as np
import pytest

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu import earlystopping as jax_es
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.datasets.iterators import (
    ListDataSetIterator as JaxListIterator,
)
from deeplearning4j_tpu.nn.conf import graph as jax_graph
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import earlystopping as es
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.checkpoint import is_sharded_checkpoint
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import graph, layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer

TOL = dict(rtol=2e-4, atol=1e-6)


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


def _data(n=64, seed=12345):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    w = rng.randn(4, 3)
    y = np.eye(3, dtype=np.float32)[np.argmax(x @ w + 0.1 * rng.randn(n, 3),
                                              axis=1)]
    return x, y


def _mlp_conf(builder, L, input_type, lr):
    return (builder().seed(42).learning_rate(lr).updater("adam")
            .weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(input_type.feed_forward(4)).build())


def _graph_conf(builder, L, G, input_type, lr):
    return (builder().seed(42).learning_rate(lr).updater("adam")
            .weight_init("xavier").graph_builder().add_inputs("in")
            .add_layer("d", L.DenseLayer(n_out=16, activation="relu"), "in")
            .add_layer("out", L.OutputLayer(n_out=3, activation="softmax",
                                            loss_function="mcxent"), "d")
            .set_outputs("out").set_input_types(input_type.feed_forward(4))
            .build())


def _np_tree(tree):
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


def _pair(engine="mlp", lr=0.05):
    """(port net on the CPU, reference net) from the reference's params."""
    if engine == "mlp":
        jnet = JaxMLN(_mlp_conf(JaxNNC.builder, jax_layers, JaxInputType,
                                lr)).init()
        pnet = MultiLayerNetwork(_mlp_conf(NeuralNetConfiguration.builder,
                                           layers, InputType, lr),
                                 device="cpu")
    else:
        jnet = JaxGraph(_graph_conf(JaxNNC.builder, jax_layers, jax_graph,
                                    JaxInputType, lr)).init()
        pnet = ComputationGraph(_graph_conf(
            NeuralNetConfiguration.builder, layers, graph, InputType, lr),
            device="cpu")
    return pnet.init(params=interop.params_from_numpy(
        _np_tree(jnet.params_tree))), jnet


def _iterators(engine, x, y):
    """(port iterator, reference iterator) over batches of 16."""
    if engine == "mlp":
        return (ListDataSetIterator(DataSet(x, y), batch_size=16),
                JaxListIterator(JaxDataSet(x, y), batch_size=16))
    return ([MultiDataSet([x[i:i + 16]], [y[i:i + 16]])
             for i in range(0, len(x), 16)],
            [JaxMDS(features=[x[i:i + 16]], labels=[y[i:i + 16]])
             for i in range(0, len(x), 16)])


CASES = {
    "max_epochs": dict(epoch=lambda m: [m.MaxEpochsTerminationCondition(5)]),
    "score_improvement": dict(
        lr=0.0, epoch=lambda m: [
            m.ScoreImprovementEpochTerminationCondition(2),
            m.MaxEpochsTerminationCondition(50)]),
    "best_score": dict(epoch=lambda m: [
        m.BestScoreEpochTerminationCondition(0.2),
        m.MaxEpochsTerminationCondition(30)]),
    "max_score_iteration": dict(
        lr=1e4, iteration=lambda m: [
            m.MaxScoreIterationTerminationCondition(50.0)],
        epoch=lambda m: [m.MaxEpochsTerminationCondition(20)]),
    "invalid_and_time": dict(
        iteration=lambda m: [m.InvalidScoreIterationTerminationCondition(),
                             m.MaxTimeIterationTerminationCondition(600.0)],
        epoch=lambda m: [m.MaxEpochsTerminationCondition(3)]),
    "every_2_save_last": dict(
        every=2, save_last=True,
        epoch=lambda m: [m.MaxEpochsTerminationCondition(5)]),
}


def _run(m, case, net, it, scorer, saver):
    spec = CASES[case]
    b = (m.EarlyStoppingConfiguration.builder()
         .model_saver(saver)
         .epoch_termination_conditions(*spec["epoch"](m))
         .iteration_termination_conditions(
             *spec.get("iteration", lambda _: [])(m))
         .evaluate_every_n_epochs(spec.get("every", 1))
         .save_last_model(spec.get("save_last", False)))
    if scorer is not None:
        b = b.score_calculator(scorer)
    return m.EarlyStoppingTrainer(b.build(), net, it).fit()


@pytest.mark.parametrize("engine", ["mlp", "graph"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_result_is_the_references(case, engine):
    x, y = _data()
    pnet, jnet = _pair(engine, CASES[case].get("lr", 0.05))
    pit, jit = _iterators(engine, x, y)
    if case == "max_score_iteration":
        pscore = jscore = None  # scored on the train score
    elif engine == "mlp":
        pscore = es.DataSetLossCalculator(DataSet(x, y))
        jscore = jax_es.DataSetLossCalculator(JaxDataSet(x, y))
    else:
        pscore = es.DataSetLossCalculator(list(pit))
        jscore = jax_es.DataSetLossCalculator(list(jit))
    got = _run(es, case, pnet, pit, pscore, es.InMemoryModelSaver())
    want = _run(jax_es, case, jnet, jit, jscore, jax_es.InMemoryModelSaver())
    assert (got.total_epochs, got.termination_reason,
            got.termination_details, got.best_model_epoch) == (
        want.total_epochs, want.termination_reason,
        want.termination_details, want.best_model_epoch)
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    for e, s in want.score_vs_epoch.items():
        np.testing.assert_allclose(got.score_vs_epoch[e], float(s), **TOL)
    if np.isfinite(want.best_model_score):
        np.testing.assert_allclose(got.best_model_score,
                                   float(want.best_model_score), **TOL)
    if case != "max_score_iteration":  # that run diverges on purpose
        np.testing.assert_allclose(got.best_model.params(),
                                   np.asarray(want.best_model.params()),
                                   **TOL)
    assert got.best_model is not pnet or want.best_model is jnet


SCORES = [[1.0, 0.9, 0.95, 0.96, 0.97, 0.5], [0.5, 0.5, 0.5, 0.5],
          [3.0, 2.0, 1.0, 0.1], [1.0, float("nan"), float("inf"), 60.0]]
CONDITIONS = {
    "MaxEpochsTerminationCondition": (3,),
    "BestScoreEpochTerminationCondition": (0.5,),
    "ScoreImprovementEpochTerminationCondition": (1, 0.05),
    "MaxScoreIterationTerminationCondition": (50.0,),
    "InvalidScoreIterationTerminationCondition": (),
    "MaxTimeIterationTerminationCondition": (0.0,),
}


@pytest.mark.parametrize("scores", range(len(SCORES)))
@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_termination_conditions_are_the_references(name, scores):
    got = getattr(es, name)(*CONDITIONS[name])
    want = getattr(jax_es, name)(*CONDITIONS[name])
    epoch = isinstance(got, es.EpochTerminationCondition)
    assert epoch != isinstance(got, es.IterationTerminationCondition)
    for cond in (got, want):
        cond.initialize()
    for i, s in enumerate(SCORES[scores]):
        if epoch:
            assert got.terminate(i, s) == want.terminate(i, s), (i, s)
        else:
            assert got.terminate(s) == want.terminate(s), (i, s)


def test_base_conditions_are_abstract():
    with pytest.raises(NotImplementedError):
        es.EpochTerminationCondition().terminate(0, 1.0)
    with pytest.raises(NotImplementedError):
        es.IterationTerminationCondition().terminate(1.0)


@pytest.mark.parametrize("average", [True, False])
def test_loss_calculator_is_the_references(average):
    x, y = _data()
    pnet, jnet = _pair()
    for data in ("dataset", "iterator"):
        if data == "dataset":
            src = (DataSet(x, y), JaxDataSet(x, y))
        else:
            src = (ListDataSetIterator(DataSet(x, y), batch_size=24),
                   JaxListIterator(JaxDataSet(x, y), batch_size=24))
        got = es.DataSetLossCalculator(src[0], average).calculate_score(pnet)
        want = jax_es.DataSetLossCalculator(src[1],
                                            average).calculate_score(jnet)
        np.testing.assert_allclose(got, float(want), **TOL)
    assert np.isnan(es.DataSetLossCalculator([]).calculate_score(pnet))


@pytest.mark.parametrize("fmt", ["zip", "sharded"])
def test_port_saver_files_load_in_the_reference(tmp_path, fmt):
    x, y = _data()
    pnet, _ = _pair()
    pnet.fit(x, y)
    saver = es.LocalFileModelSaver(str(tmp_path), format=fmt, device="cpu")
    assert saver.get_best_model() is None
    saver.save_best_model(pnet, 0.5)
    saver.save_latest_model(pnet, 0.5)
    if fmt == "sharded":
        assert is_sharded_checkpoint(str(tmp_path / "bestModel"))
    else:
        assert os.path.isfile(tmp_path / "bestModel.zip")
    for name in ("best", "latest"):
        mine = getattr(saver, f"get_{name}_model")()
        np.testing.assert_array_equal(mine.params(), pnet.params())
        np.testing.assert_array_equal(mine.updater_state_flat(),
                                      pnet.updater_state_flat())
        theirs = getattr(jax_es.LocalFileModelSaver(str(tmp_path),
                                                    format=fmt),
                         f"get_{name}_model")()
        np.testing.assert_array_equal(np.asarray(theirs.params()),
                                      pnet.params())


@pytest.mark.parametrize("fmt", ["zip", "sharded"])
def test_reference_saver_files_load_in_the_port(tmp_path, fmt):
    x, y = _data()
    _, jnet = _pair()
    jnet.fit(x, y)
    jax_es.LocalFileModelSaver(str(tmp_path), format=fmt).save_best_model(
        jnet, 0.5)
    back = es.LocalFileModelSaver(str(tmp_path), format=fmt,
                                  device="cpu").get_best_model()
    assert isinstance(back, MultiLayerNetwork)
    np.testing.assert_array_equal(back.params(), np.asarray(jnet.params()))
    assert back.iteration == jnet.iteration


def test_zip_saver_survives_crash_mid_save(tmp_path, monkeypatch):
    x, y = _data()
    pnet, _ = _pair()
    pnet.fit(x, y)
    saver = es.LocalFileModelSaver(str(tmp_path), device="cpu")
    saver.save_best_model(pnet, 0.5)
    good = saver.get_best_model().params()
    real = model_serializer.save_model

    def crashing(net, path, **kw):
        real(net, path, **kw)  # the bytes reach the tmp file...
        raise OSError("disk full")  # ...then the writer dies

    monkeypatch.setattr(model_serializer, "save_model", crashing)
    pnet.fit(x, y)
    with pytest.raises(OSError):
        saver.save_best_model(pnet, 0.4)
    np.testing.assert_array_equal(saver.get_best_model().params(), good)
    assert not np.array_equal(pnet.params(), good)


def test_in_memory_saver_keeps_a_copy():
    x, y = _data()
    pnet, _ = _pair()
    saver = es.InMemoryModelSaver()
    assert saver.get_best_model() is None and saver.get_latest_model() is None
    saver.save_best_model(pnet, 1.0)
    saver.save_latest_model(pnet, 1.0)
    kept = pnet.params().copy()
    pnet.fit(x, y)
    for copy in (saver.get_best_model(), saver.get_latest_model()):
        assert copy is not pnet
        np.testing.assert_array_equal(copy.params(), kept)


def test_bad_format_refused(tmp_path):
    with pytest.raises(ValueError, match="format"):
        es.LocalFileModelSaver(str(tmp_path), format="hdf5")


def test_trainer_with_local_files_reloads_the_best_model(tmp_path):
    x, y = _data()
    pnet, _ = _pair()
    it = ListDataSetIterator(DataSet(x, y), batch_size=16)
    cfg = (es.EarlyStoppingConfiguration.builder()
           .score_calculator(es.DataSetLossCalculator(DataSet(x, y)))
           .model_saver(es.LocalFileModelSaver(str(tmp_path),
                                               format="sharded",
                                               device="cpu"))
           .epoch_termination_conditions(es.MaxEpochsTerminationCondition(3))
           .save_last_model()
           .build())
    result = es.EarlyStoppingTrainer(cfg, pnet, it).fit()
    assert result.total_epochs == 3 and result.best_model is not pnet
    assert result.best_model.iteration == 4 * (result.best_model_epoch + 1)
    np.testing.assert_allclose(result.best_model.score(DataSet(x, y)),
                               result.best_model_score, rtol=1e-6)
    latest = cfg.model_saver.get_latest_model()
    np.testing.assert_array_equal(latest.params(), pnet.params())
