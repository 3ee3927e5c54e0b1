"""The port's config DSL against the JAX package, on the CPU:
`NeuralNetConfiguration.builder()` with `list()` and `graph_builder()`,
`to_json` / `from_json` / YAML, the layer confs, the 14 graph vertices, the
weight inits and distributions, the uint8 wire policy, and the refusals at
construction.

- JSON parity: every zoo config, ResNet-50 in both forms, and the seeded
  stacks of `tests/test_config_fuzz.py` (12 `test_random_config`, 12
  `test_random_graph_topology`, built here by the same seeds and draws in
  both packages; the JAX side is checked against the fuzz's own builder):
  `json.loads` of the port's `to_json()` equals the reference's, and each
  package's `from_json` reads the other's JSON and writes it back
  unchanged. Dicts are compared, not strings.
- Train parity: each fuzz stack the port runs is built through the port's
  builder, given the reference's params, and takes one `fit` step on one
  seeded batch; score, params and updater state within rtol 2e-4, atol
  1e-6 (f32: sums in another order). A stack holding a `DropoutLayer`
  trains under the reference's own dropout masks (the port's draw
  function swapped for `jax.random.bernoulli` at the reference's keys);
  one holding a `MoELayer` trains with the reference's routing (its
  jitter's `draw_uniform` swapped for `jax.random.uniform` too).
- Vertices: each vertex's `apply` against the reference's, output and
  gradient (one seeded cotangent) within 1e-6 in f32; `MergeVertex` on an
  NHWC input, `ElementWiseVertex` in all five ops, `L2Vertex` at equal
  inputs (its gradient is 0 there, not NaN). A graph holding all 14 kinds
  matches the reference in `output` and one `fit` step.
- Weight inits and distributions: mean, standard deviation and range of
  >= 10^5 draws of each of the 17 schemes and 4 distributions against the
  reference's draws of the same call (the streams differ: RNG parity is
  not a goal): means within 0.02 of the standard deviation, standard
  deviations within 2%, and every draw inside the scheme's range (uniform
  bounds; integer range for the binomial; 6 standard deviations for the
  normal schemes).
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn import weights as jax_weights
from deeplearning4j_tpu.nn.conf import distributions as jax_dist
from deeplearning4j_tpu.nn.conf import graph as jax_graph
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import neural_net as jax_nn
from deeplearning4j_tpu.nn.conf import preprocessors as jax_pre
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import resnet, zoo
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.nn.conf import distributions
from deeplearning4j_tpu_torch.nn.conf import dtype_policy
from deeplearning4j_tpu_torch.nn.conf import enums
from deeplearning4j_tpu_torch.nn.conf import graph
from deeplearning4j_tpu_torch.nn.conf import inputs
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf import neural_net
from deeplearning4j_tpu_torch.nn.conf import preprocessors
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import common
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

import test_config_fuzz as fuzz

F32 = dict(rtol=2e-4, atol=1e-6)
VERTEX_TOL = dict(rtol=1e-6, atol=1e-6)

# The two packages as namespaces of the same names.
JAX = types.SimpleNamespace(L=jax_layers, G=jax_graph, P=jax_pre,
                            I=jax_inputs.InputType, NN=jax_nn,
                            MLN=JaxMLN, CG=JaxGraph, DS=JaxDataSet,
                            MDS=JaxMDS)
PORT = types.SimpleNamespace(L=layers, G=graph, P=preprocessors,
                             I=inputs.InputType, NN=neural_net,
                             MLN=MultiLayerNetwork, CG=ComputationGraph,
                             DS=DataSet, MDS=MultiDataSet)


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
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


def jax_draw(key, retain, shape, device):
    """The reference's dropout mask for the layer `key` names (swapped in
    for the port's `common.draw_keep`)."""
    keep = jax.random.bernoulli(jnp.asarray(key.words), retain, tuple(shape))
    return torch.from_numpy(np.array(keep)).to(device)


def jax_uniform(key, low, high, shape, dtype, device):
    """The reference's MoE router jitter for the layer `key` names (swapped
    in for the port's `common.draw_uniform`); f32 nets only."""
    u = jax.random.uniform(jnp.asarray(common.key_words(key)), tuple(shape),
                           jnp.float32, low, high)
    return torch.from_numpy(np.array(u)).to(device, dtype)


def _assert_json_parity(port_conf, jax_conf, port_cls, jax_cls):
    port_d = json.loads(port_conf.to_json())
    jax_d = json.loads(jax_conf.to_json())
    assert port_d == jax_d
    # Each package reads the other's JSON and writes it back unchanged.
    assert json.loads(port_cls.from_json(jax_conf.to_json()).to_json()) \
        == jax_d
    assert json.loads(jax_cls.from_json(port_conf.to_json()).to_json()) \
        == port_d


# --------------------------------------------------------- zoo configs

ZOO = {
    "mlp_mnist": lambda m: m.mlp_mnist(),
    "lenet_mnist": lambda m: m.lenet_mnist(),
    "char_rnn": lambda m: m.char_rnn(vocab_size=11, hidden=8),
    "vgg16": lambda m: m.vgg16(n_classes=10),
    "alexnet": lambda m: m.alexnet(n_classes=10),
    "transformer_lm": lambda m: m.transformer_lm(
        64, t=32, d_model=32, n_heads=4, n_blocks=2),
    "transformer_lm_moe": lambda m: m.transformer_lm(
        64, t=32, d_model=32, n_heads=4, n_blocks=2, moe=True),
    "transformer_lm_cache": lambda m: m.transformer_lm(
        64, t=32, d_model=32, n_heads=4, n_blocks=2,
        decode_cache_length=48),
    "transformer_classifier": lambda m: m.transformer_classifier(
        64, 3, t=32, d_model=32, n_heads=4),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_json_equals_the_reference(name):
    port, ref = ZOO[name](zoo), ZOO[name](jax_zoo)
    graph_conf = isinstance(ref, jax_nn.ComputationGraphConfiguration)
    _assert_json_parity(
        port, ref,
        neural_net.ComputationGraphConfiguration if graph_conf
        else neural_net.MultiLayerConfiguration,
        jax_nn.ComputationGraphConfiguration if graph_conf
        else jax_nn.MultiLayerConfiguration)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet_json_equals_the_reference(fused):
    kw = dict(n_classes=5, image=32, dtype="float32", fused_blocks=fused)
    _assert_json_parity(resnet.resnet50(**kw), jax_resnet.resnet50(**kw),
                        neural_net.ComputationGraphConfiguration,
                        jax_nn.ComputationGraphConfiguration)


def test_yaml_round_trip():
    conf = zoo.lenet_mnist()
    back = neural_net.MultiLayerConfiguration.from_yaml(conf.to_yaml())
    assert back == conf
    g = resnet.resnet50(n_classes=5, image=32, fused_blocks=True)
    assert json.loads(neural_net.ComputationGraphConfiguration.from_yaml(
        g.to_yaml()).to_json()) == json.loads(g.to_json())


# ------------------------------------------------------ fuzz stacks

def _random_stack(rng, ns):
    """`test_config_fuzz._random_stack` over either package's layers: the
    same draws in the same order."""
    L = ns.L
    acts = fuzz.ACTS
    rnn = bool(rng.randint(2))
    width = int(rng.choice([8, 12, 16]))
    stack = []
    kind = "rnn" if rnn else "ff"
    for _ in range(rng.randint(2, 5)):
        if kind == "rnn":
            choice = rng.choice(
                ["dense", "lstm", "graves", "simple", "attn", "moe",
                 "ln", "bn", "act", "drop", "pool"])
        else:
            choice = rng.choice(["dense", "ln", "bn", "act", "drop"])
        act = str(rng.choice(acts))
        if choice == "dense":
            stack.append(L.DenseLayer(n_out=width, activation=act))
        elif choice == "lstm":
            stack.append(L.LSTM(n_out=width, activation="tanh"))
        elif choice == "graves":
            stack.append(L.GravesLSTM(n_out=width, activation="tanh"))
        elif choice == "simple":
            stack.append(L.SimpleRnn(n_out=width, activation="tanh"))
        elif choice == "attn":
            stack.append(L.SelfAttentionLayer(
                n_out=width, n_heads=int(rng.choice([2, 4])),
                causal=bool(rng.randint(2)), attention_impl="dense"))
        elif choice == "moe":
            stack.append(L.MoELayer(n_out=width, n_experts=2,
                                    expert_hidden=2 * width,
                                    top_k=int(rng.choice([1, 2]))))
        elif choice == "ln":
            stack.append(L.LayerNormalization())
        elif choice == "bn":
            stack.append(L.BatchNormalization())
        elif choice == "act":
            stack.append(L.ActivationLayer(activation=act))
        elif choice == "drop":
            stack.append(L.DropoutLayer(dropout=0.8))
        elif choice == "pool":
            stack.append(L.GlobalPoolingLayer(
                pooling_type=str(rng.choice(["max", "avg", "sum"]))))
            kind = "ff"
    if kind == "rnn":
        stack.append(L.RnnOutputLayer(n_out=3, activation="softmax",
                                      loss_function="mcxent"))
    else:
        stack.append(L.OutputLayer(n_out=3, activation="softmax",
                                   loss_function="mcxent"))
    return rnn, kind, stack


def _fuzz_stack_conf(i, ns):
    """`test_random_config(i)`'s conf, built in package `ns`."""
    rng = np.random.RandomState(1000 + i)
    rnn, kind, stack = _random_stack(rng, ns)
    builder = (ns.NN.NeuralNetConfiguration.builder()
               .seed(int(rng.randint(1 << 16))).learning_rate(0.05)
               .updater(str(rng.choice(["sgd", "adam", "rmsprop"])))
               .list())
    for layer in stack:
        builder = builder.layer(layer)
    f, t = 6, 8
    conf = builder.set_input_type(
        ns.I.recurrent(f, t) if rnn else ns.I.feed_forward(f)).build()
    return conf, rnn, kind


def _fuzz_graph_conf(i, ns):
    """`test_random_graph_topology(i)`'s conf, built in package `ns`."""
    rng = np.random.RandomState(2000 + i)
    f, width = 5, 8
    n_inputs = int(rng.randint(1, 3))
    ins = [f"in{k}" for k in range(n_inputs)]
    gb = (ns.NN.NeuralNetConfiguration.builder()
          .seed(int(rng.randint(1 << 16))).learning_rate(0.05)
          .updater(str(rng.choice(["sgd", "adam"])))
          .graph_builder()
          .add_inputs(*ins))
    nodes = list(ins)
    widths = {n: f for n in ins}
    for j in range(rng.randint(2, 6)):
        k = int(rng.randint(1, 3))
        srcs = [nodes[int(rng.randint(len(nodes)))] for _ in range(k)]
        if len(srcs) == 2:
            if widths[srcs[0]] == widths[srcs[1]] and rng.randint(2):
                vname = f"ew{j}"
                gb.add_vertex(vname, ns.G.ElementWiseVertex(op="add"), *srcs)
                widths[vname] = widths[srcs[0]]
            else:
                vname = f"mg{j}"
                gb.add_vertex(vname, ns.G.MergeVertex(), *srcs)
                widths[vname] = widths[srcs[0]] + widths[srcs[1]]
            src = vname
            nodes.append(vname)
        else:
            src = srcs[0]
        lname = f"d{j}"
        gb.add_layer(lname, ns.L.DenseLayer(
            n_out=width, activation=str(rng.choice(fuzz.ACTS))), src)
        widths[lname] = width
        nodes.append(lname)
    gb.add_layer("out", ns.L.OutputLayer(n_out=3, activation="softmax",
                                         loss_function="mcxent"), nodes[-1])
    gb.set_outputs("out")
    gb.set_input_types(*[ns.I.feed_forward(f)] * n_inputs)
    return gb.build(), n_inputs


def test_the_copied_generators_are_the_fuzz_tests_own():
    # The fuzz's own `_random_stack` draws the same stacks as the copy.
    for i in range(12):
        rng = np.random.RandomState(1000 + i)
        _, _, _, theirs, _ = fuzz._random_stack(rng)
        _, _, ours = _random_stack(np.random.RandomState(1000 + i), JAX)
        assert [x.to_dict() for x in ours] == [x.to_dict() for x in theirs]


@pytest.mark.parametrize("i", range(12))
def test_fuzz_stack_json_equals_the_reference(i):
    _assert_json_parity(_fuzz_stack_conf(i, PORT)[0],
                        _fuzz_stack_conf(i, JAX)[0],
                        neural_net.MultiLayerConfiguration,
                        jax_nn.MultiLayerConfiguration)


@pytest.mark.parametrize("i", range(12))
def test_fuzz_graph_json_equals_the_reference(i):
    _assert_json_parity(_fuzz_graph_conf(i, PORT)[0],
                        _fuzz_graph_conf(i, JAX)[0],
                        neural_net.ComputationGraphConfiguration,
                        jax_nn.ComputationGraphConfiguration)


def _assert_step(pnet, jnet):
    np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                               **F32)
    np.testing.assert_allclose(pnet.params(), np.asarray(jnet.params()),
                               **F32)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **F32)


@pytest.mark.parametrize("i", range(12))
def test_fuzz_stack_trains_as_the_reference(i, monkeypatch):
    pconf, rnn, kind = _fuzz_stack_conf(i, PORT)
    monkeypatch.setattr(common, "draw_keep", jax_draw)
    monkeypatch.setattr(common, "draw_uniform", jax_uniform)
    jnet = JaxMLN(_fuzz_stack_conf(i, JAX)[0]).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state)))
    rng = np.random.RandomState(3000 + i)
    b, t, f = 4, 8, 6
    x = (rng.randn(b, t, f) if rnn else rng.randn(b, f)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (b, t) if kind == "rnn"
                                               else b)]
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    _assert_step(pnet, jnet)


@pytest.mark.parametrize("i", range(12))
def test_fuzz_graph_trains_as_the_reference(i):
    pconf, n_inputs = _fuzz_graph_conf(i, PORT)
    jnet = JaxGraph(_fuzz_graph_conf(i, JAX)[0]).init()
    pnet = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    rng = np.random.RandomState(4000 + i)
    xs = [rng.randn(4, 5).astype(np.float32) for _ in range(n_inputs)]
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    jnet.fit(JaxMDS(features=xs, labels=[y]))
    pnet.fit(MultiDataSet(features=xs, labels=[y]))
    _assert_step(pnet, jnet)


# ---------------------------------------------------------- vertices

def _vertex_cases():
    """(id, vertex kwargs name, kwargs, input shapes, extra apply kwargs)."""
    return [
        ("merge_cnn", "MergeVertex", {}, [(2, 3, 3, 4), (2, 3, 3, 5)], {}),
        ("merge_ff", "MergeVertex", {}, [(3, 4), (3, 2), (3, 5)], {}),
        *[(f"elementwise_{op}", "ElementWiseVertex", {"op": op},
           [(3, 2, 4)] * (2 if op == "subtract" else 3), {})
          for op in ("add", "subtract", "product", "average", "max")],
        ("subset", "SubsetVertex", {"from_index": 1, "to_index": 3},
         [(3, 2, 6)], {}),
        ("stack", "StackVertex", {}, [(2, 4), (2, 4), (2, 4)], {}),
        ("unstack", "UnstackVertex", {"from_index": 1, "stack_size": 3},
         [(6, 4)], {}),
        ("scale", "ScaleVertex", {"scale_factor": -1.5}, [(3, 4)], {}),
        ("shift", "ShiftVertex", {"shift_factor": 0.25}, [(3, 4)], {}),
        ("l2", "L2Vertex", {}, [(3, 2, 4), (3, 2, 4)], {}),
        ("l2normalize", "L2NormalizeVertex", {}, [(3, 2, 2, 3)], {}),
        ("preprocessor", "PreprocessorVertex",
         {"preprocessor": "CnnToFeedForwardPreProcessor"}, [(2, 3, 3, 2)],
         {}),
        ("last_time_step", "LastTimeStepVertex", {}, [(3, 5, 4)], {}),
        ("duplicate_to_time_series", "DuplicateToTimeSeriesVertex",
         {"input_name": "seq"}, [(3, 4)], {"time_steps": 5}),
        ("reverse_time_series", "ReverseTimeSeriesVertex", {}, [(3, 5, 4)],
         {}),
    ]


def _vertex(ns, kind, kwargs):
    kwargs = dict(kwargs)
    if "preprocessor" in kwargs:
        kwargs["preprocessor"] = getattr(ns.P, kwargs["preprocessor"])(3, 3, 2)
    return getattr(ns.G, kind)(**kwargs)


@pytest.mark.parametrize("case", _vertex_cases(), ids=lambda c: c[0])
def test_vertex_matches_the_reference(case):
    _, kind, kwargs, shapes, extra = case
    rng = np.random.RandomState(7)
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    jv, pv = _vertex(JAX, kind, kwargs), _vertex(PORT, kind, kwargs)
    assert pv.to_dict() == jv.to_dict()

    def jax_apply(*a):
        if kind == "DuplicateToTimeSeriesVertex":
            return jv.apply(list(a), time_steps=extra["time_steps"])
        return jv.apply(list(a))

    jout, vjp = jax.vjp(jax_apply, *[jnp.asarray(x) for x in xs])
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    pout = pv.apply(ts, **extra)
    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               **VERTEX_TOL)
    cot = rng.randn(*pout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    pgrads = torch.autograd.grad(pout, ts, torch.from_numpy(cot))
    for jg, pg in zip(jgrads, pgrads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), **VERTEX_TOL)


def test_l2_vertex_gradient_at_equal_inputs_is_zero():
    a = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    ta, tb = (torch.tensor(a, requires_grad=True) for _ in range(2))
    out = graph.L2Vertex().apply([ta, tb])
    ga, gb = torch.autograd.grad(out.sum(), [ta, tb])
    jga, jgb = jax.grad(lambda x, y: jax_graph.L2Vertex().apply(
        [x, y]).sum(), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(a))
    for got, want in ((ga, jga), (gb, jgb)):
        assert torch.isfinite(got).all()
        assert not got.any()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(out.detach().numpy(), np.sqrt(1e-8),
                               rtol=1e-6)


@pytest.mark.parametrize("case", _vertex_cases(), ids=lambda c: c[0])
def test_vertex_output_type_matches_the_reference(case):
    _, kind, kwargs, shapes, _ = case

    def types_of(ns):
        out = []
        for s in shapes:
            if len(s) == 4:
                out.append(ns.I.convolutional(*s[1:]))
            elif len(s) == 3:
                out.append(ns.I.recurrent(s[2], s[1]))
            else:
                out.append(ns.I.feed_forward(s[1]))
        return out

    got = _vertex(PORT, kind, kwargs).get_output_type(*types_of(PORT))
    want = _vertex(JAX, kind, kwargs).get_output_type(*types_of(JAX))
    assert got.to_dict() == want.to_dict()


def _vertex_graph(ns, width=8, classes=3):
    """Every vertex kind in one graph: inputs "seq" [b, t, f] and "vec"
    [b, f]; a dense layer on each, the vector copied along time and added
    to the sequence, reversed, its last step merged with the vector,
    subset, the five elementwise ops, scale, shift, L2 normalization, a
    stack of two and its halves, their L2 distance, a preprocessor vertex
    to NHWC and a dense layer that the builder gives a CnnToFeedForward
    preprocessor, merged into a softmax head."""
    L, G = ns.L, ns.G
    gb = (ns.NN.NeuralNetConfiguration.builder().seed(5).learning_rate(0.05)
          .updater("adam").weight_init("xavier")
          .graph_builder().add_inputs("seq", "vec"))
    gb.add_layer("d_seq", L.DenseLayer(n_out=width, activation="tanh"), "seq")
    gb.add_layer("d_vec", L.DenseLayer(n_out=width, activation="tanh"), "vec")
    gb.add_vertex("dup", G.DuplicateToTimeSeriesVertex(input_name="seq"),
                  "d_vec")
    gb.add_vertex("seqsum", G.ElementWiseVertex(op="add"), "d_seq", "dup")
    gb.add_vertex("rev", G.ReverseTimeSeriesVertex(), "seqsum")
    gb.add_vertex("last", G.LastTimeStepVertex(), "rev")
    gb.add_vertex("merge", G.MergeVertex(), "last", "d_vec")
    gb.add_vertex("sub", G.SubsetVertex(from_index=width // 2,
                                        to_index=width // 2 + width - 1),
                  "merge")
    gb.add_vertex("e_add", G.ElementWiseVertex(op="add"), "sub", "d_vec",
                  "last")
    gb.add_vertex("e_sub", G.ElementWiseVertex(op="subtract"), "e_add",
                  "d_vec")
    gb.add_vertex("e_prod", G.ElementWiseVertex(op="product"), "e_sub",
                  "last")
    gb.add_vertex("e_avg", G.ElementWiseVertex(op="average"), "e_prod", "sub")
    gb.add_vertex("e_max", G.ElementWiseVertex(op="max"), "e_avg", "d_vec")
    gb.add_vertex("scale", G.ScaleVertex(scale_factor=0.5), "e_max")
    gb.add_vertex("shift", G.ShiftVertex(shift_factor=0.1), "scale")
    gb.add_vertex("l2n", G.L2NormalizeVertex(), "shift")
    gb.add_vertex("stack", G.StackVertex(), "l2n", "sub")
    gb.add_vertex("un0", G.UnstackVertex(from_index=0, stack_size=2), "stack")
    gb.add_vertex("un1", G.UnstackVertex(from_index=1, stack_size=2), "stack")
    gb.add_vertex("l2", G.L2Vertex(), "un0", "un1")
    gb.add_vertex("cnn", G.PreprocessorVertex(
        preprocessor=ns.P.FeedForwardToCnnPreProcessor(2, 2, width // 4)),
        "un1")
    gb.add_layer("d_cnn", L.DenseLayer(n_out=width, activation="relu"), "cnn")
    gb.add_vertex("head", G.MergeVertex(), "l2", "d_cnn", "un0")
    gb.add_layer("out", L.OutputLayer(n_out=classes, activation="softmax",
                                      loss_function="mcxent"), "head")
    return (gb.set_outputs("out")
            .set_input_types(ns.I.recurrent(6, 5), ns.I.feed_forward(4))
            .build())


def test_vertex_graph_matches_the_reference():
    pconf, jconf = _vertex_graph(PORT), _vertex_graph(JAX)
    _assert_json_parity(pconf, jconf, neural_net.ComputationGraphConfiguration,
                        jax_nn.ComputationGraphConfiguration)
    kinds = {type(v).__name__ for v in pconf.vertices.values()}
    assert len(kinds) == 14
    assert isinstance(pconf.vertices["d_cnn"].preprocessor,
                      preprocessors.CnnToFeedForwardPreProcessor)
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    rng = np.random.RandomState(9)
    seq = rng.randn(4, 5, 6).astype(np.float32)
    vec = rng.randn(4, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    np.testing.assert_allclose(pnet.output(seq, vec)[0],
                               np.asarray(jnet.output(seq, vec)[0]), **F32)
    jnet.fit(JaxMDS(features=[seq, vec], labels=[y]))
    pnet.fit(MultiDataSet(features=[seq, vec], labels=[y]))
    _assert_step(pnet, jnet)


def test_stack_graph_loss_follows_the_output_batch():
    # A Stack doubles the batch: the labels and the loss's divisor are the
    # output's 2b rows, as in the reference.
    def conf(ns):
        return (ns.NN.NeuralNetConfiguration.builder().seed(3)
                .learning_rate(0.1).updater("sgd").graph_builder()
                .add_inputs("a", "b")
                .add_vertex("st", ns.G.StackVertex(), "a", "b")
                .add_layer("out", ns.L.OutputLayer(
                    n_out=2, activation="softmax", loss_function="mcxent"),
                    "st")
                .set_outputs("out")
                .set_input_types(ns.I.feed_forward(3), ns.I.feed_forward(3))
                .build())

    jnet = JaxGraph(conf(JAX)).init()
    pnet = ComputationGraph(conf(PORT), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    rng = np.random.RandomState(2)
    a, b = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]
    jnet.fit(JaxMDS(features=[a, b], labels=[y]))
    pnet.fit(MultiDataSet(features=[a, b], labels=[y]))
    _assert_step(pnet, jnet)


# ----------------------------------------------- weight inits, dists

SCHEMES = [s.value for s in enums.WeightInit]
DISTS = {
    "normal": lambda m: m.NormalDistribution(mean=0.5, std=2.0),
    "gaussian": lambda m: m.GaussianDistribution(mean=-1.0, std=0.25),
    "uniform": lambda m: m.UniformDistribution(lower=-0.2, upper=0.6),
    "binomial": lambda m: m.BinomialDistribution(number_of_trials=5,
                                                 probability_of_success=0.3),
}
UNIFORM_BOUND = {
    "uniform": lambda fi, fo, s: 1.0 / np.sqrt(fi),
    "xavier_uniform": lambda fi, fo, s: np.sqrt(6.0 / (fi + fo)),
    "size": lambda fi, fo, s: np.sqrt(6.0 / (fi + fo)),
    "relu_uniform": lambda fi, fo, s: np.sqrt(6.0 / fi),
    "sigmoid_uniform": lambda fi, fo, s: 4 * np.sqrt(6.0 / (fi + fo)),
    "lecun_uniform": lambda fi, fo, s: np.sqrt(3.0 / fi),
    "normalized": lambda fi, fo, s: 0.5 / s[0],
    "vi": lambda fi, fo, s: np.sqrt(6.0 / (s[0] + s[1])),
}


def _check_stats(port, ref, *, low=None, high=None, sigmas=None):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.size >= 100_000
    std = ref.std()
    assert abs(port.mean() - ref.mean()) <= 0.02 * std + 1e-12
    assert abs(port.std() / std - 1) <= 0.02
    if low is not None:
        assert port.min() >= low and port.max() <= high
        # Draws reach within 1% of both ends of the range.
        assert port.min() <= low + 0.01 * (high - low)
        assert port.max() >= high - 0.01 * (high - low)
    if sigmas is not None:
        assert np.abs(port - port.mean()).max() <= sigmas * std


@pytest.mark.parametrize("scheme", SCHEMES)
def test_weight_init_matches_the_reference(scheme):
    # A 4-D HWIO shape, so that the legacy schemes read shape[:2].
    shape = (400, 300) if scheme != "identity" else (8, 8)
    if scheme in ("xavier_legacy", "vi", "normalized"):
        shape = (5, 5, 64, 80)
    fan_in, fan_out = (64 * 25, 80 * 25) if len(shape) == 4 else shape
    dist_p = distributions.NormalDistribution(0.0, 0.1)
    dist_j = jax_dist.NormalDistribution(0.0, 0.1)
    port = weights.init_weights(torch.Generator().manual_seed(1), shape,
                                fan_in, fan_out, scheme=scheme,
                                distribution=dist_p).numpy()
    ref = np.asarray(jax_weights.init_weights(
        jax.random.PRNGKey(1), shape, fan_in, fan_out, scheme=scheme,
        distribution=dist_j, dtype=jnp.float32))
    assert port.shape == ref.shape and port.dtype == np.float32
    if scheme in ("zero", "ones", "identity"):
        np.testing.assert_array_equal(port, ref)
        return
    if scheme in UNIFORM_BOUND:
        a = UNIFORM_BOUND[scheme](fan_in, fan_out, shape)
        _check_stats(port, ref, low=-a * (1 + 1e-6), high=a * (1 + 1e-6))
    else:
        _check_stats(port, ref, sigmas=6.0)


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_matches_the_reference(name):
    pd, jd = DISTS[name](distributions), DISTS[name](jax_dist)
    assert pd.to_dict() == jd.to_dict()
    assert distributions.Distribution.from_dict(jd.to_dict()) == pd
    shape = (500, 400)
    port = pd.sample(torch.Generator().manual_seed(2), shape).numpy()
    ref = np.asarray(jd.sample(jax.random.PRNGKey(2), shape, jnp.float32))
    if name == "binomial":
        assert set(np.unique(port)) == set(range(6))
        _check_stats(port, ref, low=0, high=5)
    elif name == "uniform":
        _check_stats(port, ref, low=-0.2, high=0.6)
    else:
        _check_stats(port, ref, sigmas=6.0)


def test_distribution_init_through_the_builder():
    # weight_init="distribution" (set by `dist`) draws every weight from
    # the global distribution; a layer's own dist wins for that layer.
    conf = (neural_net.NeuralNetConfiguration.builder().seed(4)
            .dist(distributions.UniformDistribution(lower=1.0, upper=2.0))
            .list()
            .layer(layers.DenseLayer(n_out=400))
            .layer(layers.OutputLayer(
                n_out=300, dist=distributions.NormalDistribution(-3.0, 0.1)))
            .set_input_type(inputs.InputType.feed_forward(300))
            .build())
    assert conf.layers[0].weight_init == "distribution"
    jconf = jax_nn.MultiLayerConfiguration.from_json(conf.to_json())
    assert jconf.layers[1].dist == jax_dist.NormalDistribution(-3.0, 0.1)
    net = MultiLayerNetwork(conf, device="cpu").init()
    w0 = net.params_tree["layer_0"]["W"].detach().numpy()
    w1 = net.params_tree["layer_1"]["W"].detach().numpy()
    assert 1.0 <= w0.min() and w0.max() <= 2.0
    assert abs(w0.mean() - 1.5) < 0.01
    assert abs(w1.mean() + 3.0) < 0.01 and abs(w1.std() - 0.1) < 0.005


def test_layer_weight_init_overrides_the_global():
    conf = (neural_net.NeuralNetConfiguration.builder().seed(4)
            .weight_init("xavier").list()
            .layer(layers.DenseLayer(n_out=500, weight_init="zero"))
            .layer(layers.OutputLayer(n_out=400, weight_init="ones"))
            .set_input_type(inputs.InputType.feed_forward(300)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    assert not net.params_tree["layer_0"]["W"].any()
    assert bool((net.params_tree["layer_1"]["W"] == 1).all())


# ---------------------------------------------------- keys, refusals

def test_unknown_keys_raise_and_none_is_dropped():
    d = json.loads(zoo.lenet_mnist().to_json())
    d["layers"][0]["lora_alpha"] = 4.0
    d["global_conf"]["mini_batch"] = False
    d["global_conf"]["max_num_line_search_iterations"] = 9
    back = neural_net.MultiLayerConfiguration.from_dict(d)
    assert json.loads(back.to_json()) == d
    for where, key in (("layer", "no_such_field"), ("global", "no_such"),
                       ("top", "no_such_key")):
        bad = json.loads(json.dumps(d))
        target = {"layer": bad["layers"][0], "global": bad["global_conf"],
                  "top": bad}[where]
        target[key] = 1
        with pytest.raises(ValueError, match=key):
            neural_net.MultiLayerConfiguration.from_dict(bad)
    g = json.loads(resnet.resnet50(n_classes=5, image=32,
                                   fused_blocks=True).to_json())
    g["vertices"]["fc"]["layer"]["bogus_knob"] = 1
    with pytest.raises(ValueError, match="bogus_knob"):
        neural_net.ComputationGraphConfiguration.from_dict(g)


@pytest.mark.parametrize("layer,item", [
    (lambda m: m.DropoutLayer(dropout=0.5), None),
    (lambda m: m.LocalResponseNormalization(), None),
    (lambda m: m.MoELayer(n_out=8, n_experts=2, router_jitter=0.1), None),
    (lambda m: m.VariationalAutoencoder(n_out=4), None),
    (lambda m: m.RBM(n_out=4), None),
    (lambda m: m.AutoEncoder(n_out=4), None),
    (lambda m: m.CenterLossOutputLayer(n_out=3), None),
    (lambda m: m.LossLayer(), None),
    (lambda m: m.DenseLayer(n_out=8, lora_rank=2), "A.12"),
], ids=["dropout", "lrn", "moe", "vae", "rbm", "ae", "center_loss",
        "loss_layer", "lora"])
def test_construction_refuses_a_conf_only_layer(layer, item, monkeypatch):
    # No layer conf is held as a conf only any more: each layer (item
    # None) builds in both engines and runs as the reference's, the
    # dropout under the reference's own masks and the MoE under its
    # jitter. DropoutLayer and LRN (A.4's) after a convolution; MoE, VAE,
    # RBM, AutoEncoder (A.9's) between dense layers, CenterLossOutputLayer
    # and LossLayer (A.9's) as the output, each also taking one `fit` step
    # (score, params, updater state, the centers). A LoRA adapter still
    # raises, naming its ROADMAP item.
    if item is None:
        monkeypatch.setattr(common, "draw_keep", jax_draw)
        monkeypatch.setattr(common, "draw_uniform", jax_uniform)
        if type(layer(layers)).__name__ not in ("DropoutLayer",
                                                "LocalResponseNormalization"):
            _a9_layer_runs_as_the_reference(layer)
            return

        def conf(ns):
            return (ns.NN.NeuralNetConfiguration.builder().seed(2).list()
                    .layer(ns.L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                                 activation="relu"))
                    .layer(layer(ns.L))
                    .layer(ns.L.OutputLayer(n_out=3))
                    .set_input_type(ns.I.convolutional(6, 6, 2)).build())

        jnet = JaxMLN(conf(JAX)).init()
        pnet = MultiLayerNetwork(conf(PORT), device="cpu").init(
            params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
        x = np.random.RandomState(1).randn(3, 6, 6, 2).astype(np.float32)
        for train in (False, True):
            np.testing.assert_allclose(
                pnet.output(x, train=train),
                np.asarray(jnet.output(x, train=train)), **F32)
        g = (PORT.NN.NeuralNetConfiguration.builder().graph_builder()
             .add_inputs("in").add_layer("x", layer(layers), "in")
             .add_layer("out", layers.OutputLayer(n_out=3), "x")
             .set_outputs("out")
             .set_input_types(inputs.InputType.convolutional(4, 4, 8))
             .build())
        assert ComputationGraph(g, device="cpu").init().output(
            np.ones((2, 4, 4, 8), np.float32))[0].shape == (2, 3)
        return
    conf = (neural_net.NeuralNetConfiguration.builder().list()
            .layer(layers.DenseLayer(n_out=8)).layer(layer(layers))
            .layer(layers.OutputLayer(n_out=3))
            .set_input_type(inputs.InputType.feed_forward(8)).build())
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        MultiLayerNetwork(conf, device="cpu")
    g = (neural_net.NeuralNetConfiguration.builder().graph_builder()
         .add_inputs("in").add_layer("x", layer(layers), "in")
         .add_layer("out", layers.OutputLayer(n_out=3), "x")
         .set_outputs("out")
         .set_input_types(inputs.InputType.feed_forward(8)).build())
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ComputationGraph(g, device="cpu")


def _a9_layer_runs_as_the_reference(layer):
    """An A.9 layer in both engines against the reference: a dense layer,
    the layer, then an OutputLayer unless the layer is an output layer
    itself; `output`, one Adam `fit` step, the declared state."""
    is_output = type(layer(layers)).__name__ in ("CenterLossOutputLayer",
                                                 "LossLayer")
    width = 3 if is_output else 8

    def body(ns, add):
        add("h", ns.L.DenseLayer(n_out=width, activation="tanh"))
        add("x", layer(ns.L))
        if not is_output:
            add("out", ns.L.OutputLayer(n_out=3, activation="softmax",
                                        loss_function="mcxent"))

    def mln(ns):
        b = (ns.NN.NeuralNetConfiguration.builder().seed(2).updater("adam")
             .learning_rate(0.01).list())
        body(ns, lambda name, lay: b.layer(lay))
        return b.set_input_type(ns.I.feed_forward(6)).build()

    def cg(ns):
        gb = (ns.NN.NeuralNetConfiguration.builder().seed(2).updater("adam")
              .learning_rate(0.01).graph_builder().add_inputs("in"))
        prev = ["in"]

        def add(name, lay):
            gb.add_layer(name, lay, prev[0])
            prev[0] = name

        body(ns, add)
        return (gb.set_outputs(prev[0])
                .set_input_types(ns.I.feed_forward(6)).build())

    rng = np.random.RandomState(6)
    x = rng.randn(5, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 5)]
    for mk, graph in ((mln, False), (cg, True)):
        jnet = (JaxGraph if graph else JaxMLN)(mk(JAX)).init()
        pnet = (ComputationGraph if graph else MultiLayerNetwork)(
            mk(PORT), device="cpu").init(
            params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
            state=interop.state_from_numpy(_np_tree(jnet.state)))
        first = (lambda o: o[0]) if graph else (lambda o: o)
        np.testing.assert_allclose(first(pnet.output(x)),
                                   np.asarray(first(jnet.output(x))), **F32)
        if graph:
            jnet.fit(JaxMDS(features=[x], labels=[y]))
            pnet.fit(MultiDataSet([x], [y]))
        else:
            jnet.fit(JaxDataSet(x, y))
            pnet.fit(DataSet(x, y))
        _assert_step(pnet, jnet)
        for name, st in pnet.state.items():
            for k, a in st.items():
                np.testing.assert_allclose(
                    a.numpy(), np.asarray(jnet.state[name][k]), **F32)


@pytest.mark.parametrize("drop", [dict(dropout=0.5),
                                  dict(dropout=0.8, use_drop_connect=True)],
                         ids=["dropout", "drop_connect"])
def test_train_mode_forward_refuses_dropout(drop, monkeypatch):
    # A train-mode forward draws inverted dropout (or DropConnect), as the
    # reference's does: under the reference's own masks `output` and
    # `feed_forward` with `train=True` equal its, each from a new key; the
    # inference forward draws nothing, and a dropout-free net's train-mode
    # forward is its inference forward.
    monkeypatch.setattr(common, "draw_keep", jax_draw)

    def conf(ns, **kw):
        return (ns.NN.NeuralNetConfiguration.builder().seed(3).list()
                .layer(ns.L.DenseLayer(n_out=8, activation="tanh", **kw))
                .layer(ns.L.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(ns.I.feed_forward(5)).build())

    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    jnet = JaxMLN(conf(JAX, **drop)).init()
    net = MultiLayerNetwork(conf(PORT, **drop), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    infer = net.output(x)
    np.testing.assert_allclose(infer, np.asarray(jnet.output(x)), **F32)
    got = net.output(x, train=True)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x, train=True)),
                               **F32)
    assert not np.allclose(got, infer)
    acts = net.feed_forward(x, train=True)
    for a, w in zip(acts, jnet.feed_forward(x, train=True)):
        np.testing.assert_allclose(a, np.asarray(w), **F32)
    np.testing.assert_array_equal(net._train_rng,
                                  np.asarray(jnet._train_rng))
    plain = MultiLayerNetwork(conf(PORT), device="cpu").init()
    np.testing.assert_array_equal(plain.output(x, train=True),
                                  plain.output(x))
    assert len(plain.feed_forward(x, train=True)) == 2


@pytest.mark.parametrize("form", ["ids_b", "ids_b1", "ids_bt1", "onehot",
                                  "onehot_format"])
def test_embedding_reads_the_reference_input_formats(form):
    # "auto" (the conf's default) gathers integer ids and takes a float
    # input whose last dim is n_in as one-hot, as the reference does.
    from deeplearning4j_tpu.nn.layers.feedforward import (
        embedding_apply as jax_embedding)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        embedding_apply)

    rng = np.random.RandomState(5)
    n_in, n_out, b, t = 10, 4, 3, 6
    fmt = "onehot" if form == "onehot_format" else "auto"
    conf = layers.EmbeddingLayer(n_in=n_in, n_out=n_out, input_format=fmt)
    jconf = jax_layers.EmbeddingLayer(n_in=n_in, n_out=n_out,
                                      input_format=fmt)
    assert conf.input_format == jconf.input_format == fmt
    params = {"W": rng.randn(n_in, n_out).astype(np.float32),
              "b": rng.randn(n_out).astype(np.float32)}
    ids = rng.randint(0, n_in, (b, t))
    x = {"ids_b": ids[:, 0], "ids_b1": ids[:, :1], "ids_bt1": ids[..., None],
         "onehot": np.eye(n_in, dtype=np.float32)[ids[:, 0]],
         "onehot_format": np.eye(n_in, dtype=np.float32)[ids]}[form]
    want, _, _ = jax_embedding(jconf, {k: jnp.asarray(v)
                                       for k, v in params.items()}, {},
                               jnp.asarray(x))
    got, _ = embedding_apply(conf, interop.params_from_numpy(
        {"l": params})["l"], {}, torch.from_numpy(np.asarray(x)))
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["vgg16", "alexnet",
                                  "transformer_classifier",
                                  "transformer_lm_moe"])
def test_conf_only_zoo_models(name):
    # VGG-16 (at its fixed 224, B=1) and AlexNet (at 67, B=2) run `output`
    # from the reference's params and match it, f32 (ROADMAP A.4's "done
    # when"); the classifier runs under a features mask; the MoE LM runs
    # `output` from the reference's params and matches it, f32 (A.9's).
    if name in ("vgg16", "alexnet"):
        def conf(m):
            if name == "vgg16":
                return m.vgg16(n_classes=10, dtype="float32")
            return m.alexnet(n_classes=10, image=67, dtype="float32")

        jnet = JaxMLN(conf(jax_zoo)).init()
        pnet = MultiLayerNetwork(conf(zoo), device="cpu").init(
            params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
        assert pnet.num_params() == sum(
            int(np.prod(s)) for layer in conf(jax_zoo).layers
            for s in layer.param_shapes().values())
        b, size = (1, 224) if name == "vgg16" else (2, 67)
        x = np.random.RandomState(5).rand(b, size, size, 3).astype(
            np.float32)
        np.testing.assert_allclose(pnet.output(x), np.asarray(
            jnet.output(x)), rtol=1e-4, atol=1e-6)
        return
    conf = ZOO[name](zoo)
    engine = (ComputationGraph if isinstance(
        conf, neural_net.ComputationGraphConfiguration)
        else MultiLayerNetwork)
    if name == "transformer_classifier":
        net = engine(conf, device="cpu").init()
        x = np.zeros((2, 32, 1), np.int64)
        mask = np.ones((2, 32), np.float32)
        mask[1, 5:] = 0.0
        out = net.output(x, features_masks=[mask])[0]
        assert out.shape == (2, 3)
        return
    jnet = JaxGraph(ZOO[name](jax_zoo)).init()
    net = engine(conf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    ids = np.random.RandomState(5).randint(0, 64, (2, 32, 1))
    np.testing.assert_allclose(
        net.output(ids.astype(np.int64))[0],
        np.asarray(jnet.output(ids.astype(np.float32))[0]), **F32)


def test_dtype_policy_round_trips_and_refuses_what_the_port_lacks():
    for v in ("mixed_bfloat16", {"name": "float32",
                                 "transfer_dtype": "bfloat16"},
              {"name": "mixed_float16", "initial_loss_scale": 1024.0}):
        p = dtype_policy.DtypePolicy.of(v)
        j = jax_nn.GlobalConf.from_dict({"dtype_policy": v}).to_dict()
        assert neural_net.GlobalConf(dtype_policy=p).to_dict() == j
    conf = (neural_net.NeuralNetConfiguration.builder()
            .dtype_policy("mixed_float16").list()
            .layer(layers.OutputLayer(n_out=3))
            .set_input_type(inputs.InputType.feed_forward(4)).build())
    assert json.loads(conf.to_json()) == json.loads(
        jax_nn.MultiLayerConfiguration.from_json(conf.to_json()).to_json())
    with pytest.raises(NotImplementedError, match="loss scaling.*A.7"):
        MultiLayerNetwork(conf, device="cpu")
    conf.global_conf.dtype_policy = dtype_policy.DtypePolicy("bfloat16")
    with pytest.raises(NotImplementedError, match="A.7"):
        MultiLayerNetwork(conf, device="cpu")
    conf.global_conf.dtype_policy = dtype_policy.DtypePolicy("mixed_bfloat16")
    assert MultiLayerNetwork(conf, device="cpu").dtype_policy.compute_dtype \
        == torch.bfloat16


def test_enums_read_any_case_as_plain_strings():
    assert enums.Updater.of("ADAM") == "adam"
    assert type(enums.Updater.of("ADAM")) is str
    assert enums.WeightInit.of(enums.WeightInit.RELU) == "relu"
    assert enums.Activation.of(None) is None
    with pytest.raises(ValueError):
        enums.LossFunction.of("no_such_loss")
    b = (neural_net.NeuralNetConfiguration.builder().updater("NESTEROVS")
         .weight_init("XAVIER_UNIFORM").optimization_algo("LBFGS")
         .gradient_normalization("ClipL2PerLayer").convolution_mode("Same")
         .learning_rate_decay_policy("Step"))
    jb = (jax_nn.NeuralNetConfiguration.builder().updater("NESTEROVS")
          .weight_init("XAVIER_UNIFORM").optimization_algo("LBFGS")
          .gradient_normalization("ClipL2PerLayer").convolution_mode("Same")
          .learning_rate_decay_policy("Step"))
    assert json.loads(json.dumps(b._g.to_dict())) == json.loads(
        json.dumps(jb._g.to_dict()))


# ------------------------------------------------------ uint8 policy

def test_uint8_policy_matches_the_reference():
    emb = layers.EmbeddingLayer(n_in=10, n_out=4, input_format="ids")
    dense = layers.DenseLayer(n_in=10, n_out=4)
    jemb = jax_layers.EmbeddingLayer(n_in=10, n_out=4, input_format="ids")
    jdense = jax_layers.DenseLayer(n_in=10, n_out=4)
    for port_c, jax_c in (([emb], [jemb]), ([dense], [jdense]),
                          ([emb, dense], [jemb, jdense]), ([None], [None]),
                          ([], [])):
        assert preprocessors.resolve_uint8_policy(port_c) == \
            jax_pre.resolve_uint8_policy(jax_c)
    x = np.arange(0, 250, 10, dtype=np.uint8).reshape(5, 5)
    scaled = preprocessors.apply_uint8_policy(
        torch.from_numpy(x), preprocessors.UINT8_SCALE, torch.float32)
    np.testing.assert_allclose(scaled.numpy(), np.asarray(
        jax_pre.apply_uint8_policy(jnp.asarray(x), jax_pre.UINT8_SCALE,
                                   jnp.float32)), rtol=1e-7)
    ids = preprocessors.apply_uint8_policy(torch.from_numpy(x),
                                           preprocessors.UINT8_IDS,
                                           torch.bfloat16)
    assert ids.dtype == torch.int64 and torch.equal(ids,
                                                    torch.from_numpy(x).long())
    with pytest.raises(ValueError, match="ambiguous"):
        preprocessors.apply_uint8_policy(torch.from_numpy(x),
                                         preprocessors.UINT8_AMBIGUOUS,
                                         torch.float32)
    i64 = torch.arange(4)
    assert preprocessors.apply_uint8_policy(i64, preprocessors.UINT8_SCALE,
                                            torch.bfloat16) is i64


def test_uint8_images_and_ids_reach_the_engines():
    # LeNet reads uint8 bytes as the reference does (0-255 -> 0-1); the LM
    # reads uint8 ids unscaled, as it reads int64 ones.
    jnet = JaxMLN(jax_zoo.lenet_mnist()).init()
    pnet = MultiLayerNetwork(zoo.lenet_mnist(), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    x = np.random.RandomState(1).randint(0, 256, (2, 28, 28, 1)).astype(
        np.uint8)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pnet.output(x),
                               pnet.output(x.astype(np.float32) / 255.0),
                               rtol=1e-6, atol=1e-7)
    lm = ComputationGraph(zoo.transformer_lm(16, t=8, d_model=8, n_heads=2,
                                             n_blocks=1), device="cpu").init()
    ids = np.random.RandomState(2).randint(0, 16, (2, 8, 1))
    np.testing.assert_array_equal(lm.output(ids.astype(np.uint8))[0],
                                  lm.output(ids)[0])


# -------------------------------------------- builder behaviour

def test_list_builder_without_input_type_chains_n_in():
    # The reference chains n_in from explicit n_outs when no input type is
    # set, and ends the chain quietly where a layer cannot tell its output.
    def conf(ns):
        return (ns.NN.NeuralNetConfiguration.builder().list()
                .layer(ns.L.DenseLayer(n_in=5, n_out=7))
                .layer(ns.L.DenseLayer(n_out=4))
                .layer(ns.L.LayerNormalization())
                .layer(ns.L.OutputLayer(n_out=3))
                .build())
    _assert_json_parity(conf(PORT), conf(JAX),
                        neural_net.MultiLayerConfiguration,
                        jax_nn.MultiLayerConfiguration)
    assert [x.n_in for x in conf(PORT).layers] == [5, 7, 4, 4]


def test_graph_builder_shares_the_global_conf_and_copies_layers():
    dense = layers.DenseLayer(n_out=4)
    gb = (neural_net.NeuralNetConfiguration.builder().l2(0.5).graph_builder()
          .add_inputs("in").add_layer("a", dense, "in")
          .add_layer("out", layers.OutputLayer(n_out=2), "a")
          .set_outputs("out")
          .set_input_types(inputs.InputType.feed_forward(3)))
    conf = gb.build()
    assert dense.l2 is None and dense.n_in == 0     # the caller's layer
    assert conf.vertices["a"].layer.l2 == 0.5
    assert conf.vertices["a"].layer.n_in == 3
    assert conf.global_conf is gb._g


def test_topological_order_matches_the_reference():
    for i in range(12):
        pconf, _ = _fuzz_graph_conf(i, PORT)
        jconf, _ = _fuzz_graph_conf(i, JAX)
        assert pconf.topological_order() == jconf.topological_order()
    r = resnet.resnet50(n_classes=5, image=32)
    assert r.topological_order() == jax_resnet.resnet50(
        n_classes=5, image=32).topological_order()
