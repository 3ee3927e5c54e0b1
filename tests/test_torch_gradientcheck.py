"""The port's `check_gradients` (`deeplearning4j_tpu_torch/gradientcheck.py`)
against the JAX package's, in float64 on the CPU, on every net of
`tests/test_gradientcheck.py` (the reference's gradient-check suite) and a
GravesLSTM whose gates are softmax: the same configuration (the port's
from the reference's JSON), the same params, the same data. The port
returns what the reference returns (True on all of them), and its largest
relative error, which both print, is within 1e-6 of the reference's (both
run the central differences in float64 with epsilon 1e-6; the two
forwards round differently in the last bits, and the quotient multiplies
that by 1 / epsilon).
"""

import re

import numpy as np
import pytest

from conftest import make_classification_data
from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.gradientcheck import check_gradients as jax_check
from deeplearning4j_tpu.nn.conf import layers as L
from deeplearning4j_tpu.nn.conf.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu.nn.conf.inputs import InputType
from deeplearning4j_tpu.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

EPS, TOL = 1e-6, 1e-5  # the reference suite's
MAX_ERR_GAP = 1e-6


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


def base():
    return (NeuralNetConfiguration.builder().seed(12345).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").dtype("float64"))


def mlp(*layers, inp=InputType.feed_forward(4), b=None):
    lb = (b or base()).list()
    for layer in layers:
        lb = lb.layer(layer)
    return lb.set_input_type(inp).build()


def out(n=3, act="softmax", loss="mcxent", rnn=False):
    cls = L.RnnOutputLayer if rnn else L.OutputLayer
    return cls(n_out=n, activation=act, loss_function=loss)


def class_data(rng, n=6, nf=4, nc=3):
    return make_classification_data(rng, n=n, n_features=nf, n_classes=nc)


def _dense_act(rng, act):
    x, y = class_data(rng)
    return mlp(L.DenseLayer(n_out=5, activation=act), out()), (x, y)


def _loss(rng, loss, act):
    x, y = class_data(rng)
    if loss == "kl_divergence":
        y = np.abs(rng.rand(6, 3)) + 0.1
        y = y / y.sum(-1, keepdims=True)
    if loss in ("hinge", "squared_hinge"):
        y = 2.0 * y - 1.0
    return mlp(L.DenseLayer(n_out=5, activation="tanh"),
               out(act=act, loss=loss)), (x, y)


def _rnn_xy(rng, b, t, f, c):
    return rng.randn(b, t, f), np.eye(c)[rng.randint(0, c, (b, t))]


MASK = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]],
                dtype="float64")


def _case(name, rng):
    """(reference conf, data) of one net of tests/test_gradientcheck.py."""
    if name == "l1_l2":
        x, y = class_data(rng)
        return mlp(L.DenseLayer(n_out=5, activation="tanh"),
                   L.OutputLayer(n_out=3, activation="softmax"),
                   b=base().l1(0.01).l2(0.02)), (x, y)
    if name == "embedding":
        idx = rng.randint(0, 7, (6,)).astype("int32")
        y = np.eye(3)[rng.randint(0, 3, 6)]
        conf = (base().list()
                .layer(L.EmbeddingLayer(n_in=7, n_out=5, activation="tanh"))
                .layer(L.OutputLayer(n_out=3, activation="softmax")).build())
        return conf, (idx, y)
    if name == "autoencoder_supervised":
        x, y = class_data(rng)
        return mlp(L.AutoEncoder(n_out=5, activation="sigmoid"),
                   L.OutputLayer(n_out=3, activation="softmax")), (x, y)
    if name == "conv_subsampling":
        x, y = rng.randn(4, 8, 8, 2), np.eye(3)[rng.randint(0, 3, 4)]
        return mlp(L.ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                      n_out=3, activation="tanh"),
                   L.SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                      stride=(2, 2)),
                   L.OutputLayer(n_out=3, activation="softmax"),
                   inp=InputType.convolutional(8, 8, 2)), (x, y)
    if name.startswith("pooling_"):
        x, y = rng.randn(3, 6, 6, 2), np.eye(2)[rng.randint(0, 2, 3)]
        return mlp(L.ConvolutionLayer(kernel_size=(2, 2), n_out=2,
                                      activation="tanh"),
                   L.SubsamplingLayer(pooling_type=name[8:],
                                      kernel_size=(2, 2), stride=(2, 2)),
                   L.OutputLayer(n_out=2, activation="softmax"),
                   inp=InputType.convolutional(6, 6, 2)), (x, y)
    if name == "conv_same_mode":
        x, y = rng.randn(3, 5, 5, 1), np.eye(2)[rng.randint(0, 2, 3)]
        return mlp(L.ConvolutionLayer(kernel_size=(3, 3), n_out=2,
                                      convolution_mode="same",
                                      activation="tanh"),
                   L.OutputLayer(n_out=2, activation="softmax"),
                   inp=InputType.convolutional(5, 5, 1)), (x, y)
    if name == "batchnorm":
        x, y = rng.randn(8, 4), np.eye(3)[rng.randint(0, 3, 8)]
        return mlp(L.DenseLayer(n_out=5, activation="tanh"),
                   L.BatchNormalization(),
                   L.OutputLayer(n_out=3, activation="softmax"),
                   b=base().activation("identity")), (x, y)
    if name == "lrn":
        x, y = rng.randn(3, 5, 5, 6), np.eye(2)[rng.randint(0, 2, 3)]
        return mlp(L.ConvolutionLayer(kernel_size=(2, 2), n_out=6,
                                      activation="tanh"),
                   L.LocalResponseNormalization(),
                   L.OutputLayer(n_out=2, activation="softmax"),
                   inp=InputType.convolutional(5, 5, 6)), (x, y)
    if name in ("graves_lstm", "softmax_gate_lstm"):
        x, y = _rnn_xy(rng, 3, 5, 4, 3)
        gate = "softmax" if name == "softmax_gate_lstm" else "sigmoid"
        return mlp(L.GravesLSTM(n_out=4, activation="tanh",
                                gate_activation=gate),
                   out(rnn=True), inp=InputType.recurrent(4)), (x, y)
    if name == "bidirectional_lstm":
        x, y = _rnn_xy(rng, 2, 4, 3, 2)
        return mlp(L.GravesBidirectionalLSTM(n_out=3, activation="tanh"),
                   L.RnnOutputLayer(n_out=2, activation="softmax"),
                   inp=InputType.recurrent(3)), (x, y)
    if name == "simple_rnn":
        x, y = _rnn_xy(rng, 3, 4, 3, 2)
        return mlp(L.SimpleRnn(n_out=4, activation="tanh"),
                   L.RnnOutputLayer(n_out=2, activation="softmax"),
                   inp=InputType.recurrent(3)), (x, y)
    if name == "lstm_with_masking":
        x, y = _rnn_xy(rng, 3, 5, 4, 3)
        return mlp(L.GravesLSTM(n_out=4, activation="tanh"),
                   L.RnnOutputLayer(n_out=3, activation="softmax"),
                   inp=InputType.recurrent(4)), (x, y, MASK, MASK)
    if name.startswith("global_pooling_"):
        x, y = rng.randn(3, 5, 4), np.eye(2)[rng.randint(0, 2, 3)]
        return mlp(L.GravesLSTM(n_out=3, activation="tanh"),
                   L.GlobalPoolingLayer(pooling_type=name[15:]),
                   L.OutputLayer(n_out=2, activation="softmax"),
                   inp=InputType.recurrent(4)), (x, y, MASK, None)
    if name == "layernorm":
        x, y = class_data(rng)
        return mlp(L.DenseLayer(n_out=5, activation="tanh"),
                   L.LayerNormalization(), out()), (x, y)
    if name == "positional_embedding":
        x = rng.randn(3, 5, 4)
        y = np.eye(3)[rng.randint(0, 3, (3, 5))].astype("float64")
        return mlp(L.PositionalEmbeddingLayer(max_length=8),
                   L.LayerNormalization(), out(rnn=True),
                   inp=InputType.recurrent(4, 5)), (x, y)
    return _graph_case(name, rng)


def _graph_case(name, rng):
    gb = base().graph_builder()
    if name == "merge_vertex":
        x, y = class_data(rng)
        conf = (gb.add_inputs("in")
                .add_layer("d1", L.DenseLayer(n_in=4, n_out=5,
                                              activation="tanh"), "in")
                .add_layer("d2", L.DenseLayer(n_in=4, n_out=4,
                                              activation="sigmoid"), "in")
                .add_vertex("merge", MergeVertex(), "d1", "d2")
                .add_layer("out", L.OutputLayer(n_in=9, n_out=3,
                                                activation="softmax"),
                           "merge")
                .set_outputs("out").build())
        return conf, ([x], [y])
    if name == "elementwise_add_residual":
        x, y = class_data(rng)
        conf = (gb.add_inputs("in")
                .add_layer("d1", L.DenseLayer(n_in=4, n_out=4,
                                              activation="tanh"), "in")
                .add_vertex("add", ElementWiseVertex(op="add"), "d1", "in")
                .add_layer("out", L.OutputLayer(n_in=4, n_out=3,
                                                activation="softmax"), "add")
                .set_outputs("out").build())
        return conf, ([x], [y])
    if name == "multi_output":
        x = rng.randn(5, 4)
        y1, y2 = np.eye(3)[rng.randint(0, 3, 5)], rng.randn(5, 2)
        conf = (gb.add_inputs("in")
                .add_layer("shared", L.DenseLayer(n_in=4, n_out=6,
                                                  activation="tanh"), "in")
                .add_layer("out1", L.OutputLayer(
                    n_in=6, n_out=3, activation="softmax",
                    loss_function="mcxent"), "shared")
                .add_layer("out2", L.OutputLayer(
                    n_in=6, n_out=2, activation="identity",
                    loss_function="mse"), "shared")
                .set_outputs("out1", "out2").build())
        return conf, ([x], [y1, y2])
    assert name == "multi_input"
    x1, x2 = rng.randn(5, 3), rng.randn(5, 2)
    y = np.eye(2)[rng.randint(0, 2, 5)]
    conf = (gb.add_inputs("a", "b")
            .add_layer("da", L.DenseLayer(n_in=3, n_out=4,
                                          activation="tanh"), "a")
            .add_layer("db", L.DenseLayer(n_in=2, n_out=4,
                                          activation="tanh"), "b")
            .add_vertex("m", MergeVertex(), "da", "db")
            .add_layer("out", L.OutputLayer(n_in=8, n_out=2,
                                            activation="softmax"), "m")
            .set_outputs("out").build())
    return conf, ([x1, x2], [y])


DENSE_ACTS = ["sigmoid", "tanh", "relu", "elu", "softplus", "rationaltanh",
              "hardsigmoid", "cube"]
LOSSES = [("mcxent", "softmax"), ("mse", "identity"), ("mse", "tanh"),
          ("xent", "sigmoid"), ("l1", "identity"),
          ("negativeloglikelihood", "softmax"), ("kl_divergence", "sigmoid"),
          ("poisson", "softplus"), ("hinge", "identity"),
          ("squared_hinge", "identity"), ("cosine_proximity", "identity")]
NETS = (["l1_l2", "embedding", "autoencoder_supervised", "conv_subsampling",
         "pooling_avg", "pooling_pnorm", "conv_same_mode", "batchnorm", "lrn",
         "graves_lstm", "softmax_gate_lstm", "bidirectional_lstm",
         "simple_rnn", "lstm_with_masking", "layernorm",
         "positional_embedding", "merge_vertex", "elementwise_add_residual",
         "multi_output", "multi_input"]
        + [f"global_pooling_{p}" for p in ("max", "avg", "sum", "pnorm")])


def _max_err(text):
    return float(re.findall(r"maxRelErr=([0-9.eE+-]+)", text)[-1])


def _run_both(conf, data, capsys):
    graph = isinstance(data[0], list)
    if graph:
        jnet = JaxCG(conf).init()
        jdata = JMultiDataSet(features=data[0], labels=data[1])
        pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
            conf.to_json()), device="cpu")
        pdata = MultiDataSet(features=data[0], labels=data[1])
    else:
        jnet = JaxMLN(conf).init()
        jdata = JDataSet(*data)
        pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            conf.to_json()), device="cpu")
        pdata = DataSet(*data)
    params = {k: {n: np.array(a) for n, a in p.items()}
              for k, p in jnet.params_tree.items()}
    state = {k: {n: np.array(a) for n, a in s.items()}
             for k, s in jnet.state.items()}
    pnet.init(params=interop.params_from_numpy(params),
              state=interop.state_from_numpy(state) if state else None)
    capsys.readouterr()
    want = jax_check(jnet, jdata, epsilon=EPS, max_rel_error=TOL,
                     print_results=True)
    want_err = _max_err(capsys.readouterr().out)
    got = check_gradients(pnet, pdata, epsilon=EPS, max_rel_error=TOL,
                          print_results=True)
    got_err = _max_err(capsys.readouterr().out)
    return want, got, want_err, got_err


def _check(conf, data, capsys):
    want, got, want_err, got_err = _run_both(conf, data, capsys)
    assert want is True
    assert got is want
    assert abs(got_err - want_err) <= MAX_ERR_GAP, (got_err, want_err)


@pytest.mark.parametrize("act", DENSE_ACTS)
def test_dense_activations(rng, act, capsys):
    _check(*_dense_act(rng, act), capsys)


@pytest.mark.parametrize("loss,act", LOSSES)
def test_loss_functions(rng, loss, act, capsys):
    _check(*_loss(rng, loss, act), capsys)


@pytest.mark.parametrize("name", NETS)
def test_nets(rng, name, capsys):
    _check(*_case(name, rng), capsys)


def test_subset_draws_the_references_indices(rng, capsys):
    # `subset` draws its indices from RandomState(seed) over the same flat
    # order: a broken analytic gradient fails the same parameters in both.
    conf, data = _dense_act(rng, "tanh")
    jnet = JaxMLN(conf).init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.init(params=interop.params_from_numpy(
        {k: {n: np.array(a) for n, a in p.items()}
         for k, p in jnet.params_tree.items()}))
    capsys.readouterr()
    jax_check(jnet, JDataSet(*data), subset=9, seed=3, print_results=True,
              max_rel_error=0.0, min_abs_error=0.0)
    want = re.findall(r"param\[(\d+)\]", capsys.readouterr().out)
    check_gradients(pnet, DataSet(*data), subset=9, seed=3,
                    print_results=True, max_rel_error=0.0,
                    min_abs_error=0.0)
    got = re.findall(r"param\[(\d+)\]", capsys.readouterr().out)
    assert got == want and len(got) >= 1
