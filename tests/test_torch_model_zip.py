"""The model zip of both engines against the JAX package, on the CPU: a
zip the port writes loads in the reference, and one the reference writes
loads in the port, for a `MultiLayerNetwork` and a `ComputationGraph`
(params, updater state, BatchNorm running statistics, iteration and
epoch), and the port's own round trip.

- The graph's flat `params()` follows the reference's vertex order (layer
  vertices in topological order) and `updater_state_flat()` its leaf
  order (keys sorted at every level): after the same steps the two flat
  views are equal within the training tolerance, and a zip carries them
  as they are.
- Loaded nets: params, updater state and running statistics bit for bit
  what was saved; `output` within 1e-6 of the writer's (the other
  package's sums run in another order); the port's own reload equal bit
  for bit, and one further `fit` step on both gives the same score.
- A reloaded or `set_params` net answers from the new params: its
  compute-dtype copy is rebuilt (bf16 policy).

Small sizes: the LM at V=16, d=8, one block; a ResNet graph of one stem,
one projecting block and one identity block at 2 filters on 16x16 images;
B=4; Adam or Nesterovs, two steps before the zip.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import graph as jax_graph
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import resnet, zoo
from deeplearning4j_tpu_torch.nn.conf import graph, layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer

F32 = dict(rtol=2e-4, atol=1e-6)
OUT = dict(rtol=1e-6, atol=1e-6)
B, IMAGE, CLASSES, V, T = 4, 16, 5, 16, 8


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
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


# ---------------------------------------------------------- the graphs

def _small_resnet(builder, helpers, L, input_type, fused):
    b = (builder().seed(7).learning_rate(0.05).updater("nesterovs")
         .momentum(0.9).weight_init("relu").l2(1e-4)
         .graph_builder().add_inputs("input"))
    x = helpers._conv_bn(b, "stem", "input", 8, (3, 3), (2, 2))
    block = helpers._bottleneck_fused if fused else helpers._bottleneck
    x = block(b, "s0_b0", x, 2, (2, 2), project=True)
    x = block(b, "s0_b1", x, 2, (1, 1), project=False)
    b.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"), x)
    b.add_layer("fc", L.OutputLayer(n_out=CLASSES, activation="softmax",
                                    loss_function="mcxent"), "avgpool")
    return (b.set_outputs("fc")
            .set_input_types(input_type.convolutional(IMAGE, IMAGE, 3))
            .build())


def _multi_io(builder, L, G, input_type):
    """`examples/csv_graph_multi_io.py`'s graph: inputs of 4 and 3
    features, dense 16 relu on each, merged, a softmax mcxent and an mse
    head; Adam at 0.05, seed 7."""
    return (builder().seed(7).learning_rate(0.05).updater("adam")
            .graph_builder()
            .add_inputs("ina", "inb")
            .add_layer("da", L.DenseLayer(n_out=16, activation="relu"),
                       "ina")
            .add_layer("db", L.DenseLayer(n_out=16, activation="relu"),
                       "inb")
            .add_vertex("m", G.MergeVertex(), "da", "db")
            .add_layer("cls", L.OutputLayer(n_out=3, activation="softmax",
                                            loss_function="mcxent"), "m")
            .add_layer("reg", L.OutputLayer(n_out=2, activation="identity",
                                            loss_function="mse"), "m")
            .set_outputs("cls", "reg")
            .set_input_types(input_type.feed_forward(4),
                             input_type.feed_forward(3))
            .build())


def _confs(kind):
    """(port conf, reference conf, one batch as (features, labels))."""
    rng = np.random.RandomState(11)
    if kind == "lm":
        kw = dict(t=T, d_model=8, n_heads=2, n_blocks=1)
        ids = rng.randint(0, V, (B, T + 1))
        batch = ([ids[:, :-1, None].astype(np.float32)],
                 [np.eye(V, dtype=np.float32)[ids[:, 1:]]])
        return (zoo.transformer_lm(V, **kw), jax_zoo.transformer_lm(V, **kw),
                batch)
    if kind == "multi_io":
        batch = ([rng.rand(B, 4).astype(np.float32),
                  rng.rand(B, 3).astype(np.float32)],
                 [np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)],
                  rng.rand(B, 2).astype(np.float32)])
        return (_multi_io(NeuralNetConfiguration.builder, layers, graph,
                          InputType),
                _multi_io(JaxNNC.builder, jax_layers, jax_graph,
                          JaxInputType), batch)
    fused = kind == "resnet_fused"
    batch = ([rng.randn(B, IMAGE, IMAGE, 3).astype(np.float32)],
             [np.eye(CLASSES, dtype=np.float32)[rng.randint(0, CLASSES, B)]])
    return (_small_resnet(NeuralNetConfiguration.builder, resnet, layers,
                          InputType, fused),
            _small_resnet(JaxNNC.builder, jax_resnet, jax_layers,
                          JaxInputType, fused), batch)


KINDS = ["lm", "multi_io", "resnet_unfused", "resnet_fused"]


def _trained_pair(kind, steps=2):
    pconf, jconf, (xs, ys) = _confs(kind)
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state)))
    for _ in range(steps):
        jnet.fit(JaxMDS(features=xs, labels=ys))
        pnet.fit(MultiDataSet(features=xs, labels=ys))
    return pnet, jnet, xs, ys


def _assert_same_net(got, want, xs, exact):
    """`got` a net loaded from `want`'s zip (either package)."""
    def arr(a):
        return np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor)
                          else a)

    np.testing.assert_array_equal(arr(got.params()), arr(want.params()))
    np.testing.assert_array_equal(arr(got.updater_state_flat()),
                                  arr(want.updater_state_flat()))
    assert set(got.state) == set(want.state)
    for lk, sub in want.state.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(arr(got.state[lk][k]), arr(v))
    assert (got.iteration, got.epoch) == (want.iteration, want.epoch)
    for g, w in zip(got.output(*xs), want.output(*xs)):
        if exact:
            np.testing.assert_array_equal(arr(g), arr(w))
        else:
            np.testing.assert_allclose(arr(g), arr(w), **OUT)


# ------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", KINDS)
def test_flat_views_follow_the_reference_order(kind):
    pnet, jnet, _, _ = _trained_pair(kind)
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **F32)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **F32)
    assert pnet.num_params() == jnet.num_params()


@pytest.mark.parametrize("kind", KINDS)
def test_port_graph_zip_loads_in_the_reference(tmp_path, kind):
    pnet, _, xs, _ = _trained_pair(kind)
    path = str(tmp_path / "graph.zip")
    model_serializer.save_model(pnet, path)
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        assert manifest["engine"] == "ComputationGraph"
        assert manifest["num_params"] == pnet.num_params()
        assert ("state.npz" in z.namelist()) == bool(pnet.state)
    _assert_same_net(jax_serializer.load_model(path), pnet, xs, exact=False)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_graph_zip_loads_in_the_port(tmp_path, kind):
    _, jnet, xs, _ = _trained_pair(kind)
    path = str(tmp_path / "graph.zip")
    jax_serializer.save_model(jnet, path)
    net = model_serializer.load_model(path, device="cpu")
    assert isinstance(net, ComputationGraph)
    _assert_same_net(net, jnet, xs, exact=False)


@pytest.mark.parametrize("kind", KINDS)
def test_port_round_trip_then_one_more_step(tmp_path, kind):
    pnet, _, xs, ys = _trained_pair(kind)
    path = str(tmp_path / "graph.zip")
    model_serializer.save_model(pnet, path)
    net = model_serializer.load_model(path, device="cpu")
    _assert_same_net(net, pnet, xs, exact=True)
    for n in (pnet, net):
        n.fit(MultiDataSet(features=xs, labels=ys))
    assert net.score_value == pnet.score_value
    np.testing.assert_array_equal(net.params(), pnet.params())


def test_port_multilayer_zip_loads_in_the_reference(tmp_path):
    conf = zoo.char_rnn(vocab_size=7, hidden=6, tbptt_length=4)
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.RandomState(3)
    x = np.eye(7, dtype=np.float32)[rng.randint(0, 7, (2, 10))]
    y = np.eye(7, dtype=np.float32)[rng.randint(0, 7, (2, 10))]
    for _ in range(2):
        net.fit(DataSet(x, y))
    path = str(tmp_path / "mln.zip")
    model_serializer.save_model(net, path)
    jnet = jax_serializer.load_model(path)
    _assert_same_net(jnet, net, [x], exact=False)
    back = model_serializer.load_model(path, device="cpu")
    _assert_same_net(back, net, [x], exact=True)


def test_without_the_updater(tmp_path):
    pnet, _, xs, _ = _trained_pair("multi_io", steps=1)
    path = str(tmp_path / "graph.zip")
    model_serializer.save_model(pnet, path, save_updater=False)
    with zipfile.ZipFile(path) as z:
        assert "updaterState.bin" not in z.namelist()
    net = model_serializer.load_model(path, device="cpu")
    assert not net.updater_state_flat().any()
    np.testing.assert_array_equal(net.params(), pnet.params())
    net = model_serializer.load_model(path, load_updater=False, device="cpu")
    assert not net.updater_state_flat().any()


def test_set_params_rebuilds_the_compute_copy():
    # bf16 compute: the inference copy is cast once, so a stale one would
    # answer from the old params.
    conf = zoo.transformer_lm(V, t=T, d_model=8, n_heads=2, n_blocks=1,
                              dtype="bfloat16")
    a = ComputationGraph(conf, device="cpu").init()
    conf_b = zoo.transformer_lm(V, t=T, d_model=8, n_heads=2, n_blocks=1,
                                dtype="bfloat16", seed=99)
    b = ComputationGraph(conf_b, device="cpu").init()
    x = np.random.RandomState(1).randint(0, V, (2, T, 1))
    before = a.output(x)[0]
    a.set_params(b.params())
    np.testing.assert_array_equal(a.output(x)[0], b.output(x)[0])
    assert np.abs(before - b.output(x)[0]).max() > 0


def test_clone_copies_the_graph():
    pnet, _, xs, ys = _trained_pair("resnet_fused", steps=1)
    twin = pnet.clone()
    _assert_same_net(twin, pnet, xs, exact=True)
    twin.fit(MultiDataSet(features=xs, labels=ys))
    assert not np.array_equal(twin.params(), pnet.params())
