"""Fine-tuning in the port (`nn/transfer.py`, `nn/lora.py`, the engines'
frozen spec) against the JAX package, on the CPU.

Each case builds the tuned net with the reference's `TransferLearning`,
carries its conf (JSON, with `frozen`, `lora_rank`, `lora_alpha` stamped)
and its params (the LoRA factors among them, since the packages draw from
different generators) into the port by name, and runs both:

- `frozen_spec`, `split_tree` / `merge_tree`, the tuned conf and the
  params' names, from the port's own `TransferLearning` too;
- freezing: frozen leaves bit for bit unchanged after `fit`, no updater
  state for them (`()` for a fully frozen layer), the updater state's
  structure and `updater_state_flat` as the reference's;
- LoRA: `output` and 3 Adam `fit` steps (score, A, B, the updater state)
  on an MLP, a ComputationGraph and a GravesLSTM net, and over an int8
  base; truncated BPTT and the superstep under a spec; masters under
  low-precision params; `clone`; the model zip and the sharded store.

Tolerances: F32 (rtol 1e-5, atol 1e-6) for a forward and one step,
STEPS (rtol 1e-4, atol 1e-6) after 3 Adam steps, where f32 rounding
differences between XLA and torch grow through m / sqrt(v); CHUNKS (rtol
1e-4, atol 2e-5) after the 6 chunk steps of truncated BPTT, where a leaf
near 0 has moved by up to 6 steps of lr 0.05 and its difference is 4e-4
of one step; BF16 (rtol 2e-2, atol 1e-3) under bf16 compute.
"""

import json
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.checkpoint import quantize as jax_quantize
from deeplearning4j_tpu.checkpoint import store as jax_store
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.nn import transfer as jax_transfer
from deeplearning4j_tpu.nn.conf import inputs as jax_inputs
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf import neural_net as jax_nn
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.checkpoint import quantize
from deeplearning4j_tpu_torch.checkpoint import store
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import lora
from deeplearning4j_tpu_torch.nn import transfer
from deeplearning4j_tpu_torch.nn.conf import inputs, layers, neural_net
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer

F32 = dict(rtol=1e-5, atol=1e-6)
STEPS = dict(rtol=1e-4, atol=1e-6)
CHUNKS = dict(rtol=1e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=1e-3)

JAX = types.SimpleNamespace(
    L=jax_layers, NN=jax_nn.NeuralNetConfiguration, I=jax_inputs.InputType,
    TL=jax_transfer.TransferLearning, MLN=JaxMLN, CG=JaxCG)
PORT = types.SimpleNamespace(
    L=layers, NN=neural_net.NeuralNetConfiguration, I=inputs.InputType,
    TL=transfer.TransferLearning,
    MLN=lambda conf: MultiLayerNetwork(conf, device="cpu"),
    CG=lambda conf: ComputationGraph(conf, device="cpu"))


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


# ------------------------------------------------------------------ nets

def _builder(ns, seed=7, updater="adam", policy=None, **g):
    b = ns.NN.builder().seed(seed).learning_rate(0.05).updater(updater)
    if policy is not None:
        b = b.dtype_policy(policy)
    for name, v in g.items():
        b = getattr(b, name)(v)
    return b


def mlp(ns, **kw):
    return ns.MLN(
        _builder(ns, **kw).list()
        .layer(ns.L.DenseLayer(n_out=8, activation="tanh"))
        .layer(ns.L.DenseLayer(n_out=8, activation="tanh"))
        .layer(ns.L.OutputLayer(n_out=3, activation="softmax",
                                loss_function="mcxent"))
        .set_input_type(ns.I.feed_forward(5)).build()).init()


def graph(ns, **kw):
    gb = (_builder(ns, **kw).graph_builder().add_inputs("in")
          .add_layer("h0", ns.L.DenseLayer(n_out=8, activation="tanh"), "in")
          .add_layer("h1", ns.L.DenseLayer(n_out=8, activation="relu"), "h0")
          .add_layer("out", ns.L.OutputLayer(n_out=3, activation="softmax",
                                             loss_function="mcxent"), "h1"))
    return ns.CG(gb.set_outputs("out")
                 .set_input_types(ns.I.feed_forward(5)).build()).init()


def lstm(ns, **kw):
    return ns.MLN(
        _builder(ns, **kw).list()
        .layer(ns.L.GravesLSTM(n_out=6, activation="tanh"))
        .layer(ns.L.RnnOutputLayer(n_out=3, activation="softmax",
                                   loss_function="mcxent"))
        .set_input_type(ns.I.recurrent(4)).build()).init()


NETS = {"mlp": mlp, "graph": graph, "lstm": lstm}


def _data(kind, seed=0, b=6, t=8):
    rng = np.random.RandomState(seed)
    if kind == "lstm":
        x = rng.randn(b, t, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (b, t))]
    else:
        x = rng.randn(b, 5).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, b)]
    return x, y


def _fit(net, kind, x, y, reference):
    if kind == "graph":
        net.fit((JMDS if reference else MultiDataSet)(features=[x],
                                                      labels=[y]))
    else:
        net.fit((JDataSet if reference else DataSet)(x, y))


def _out(net, kind, x, **kw):
    o = net.output(x, **kw)
    return np.asarray(o[0] if kind == "graph" else o)


def _np_tree(tree):
    return {k: {n: np.array(a) for n, a in p.items()}
            for k, p in tree.items() if isinstance(p, dict)}


def _port_of(jnet, **init):
    """The reference's net in the port: its conf by JSON, its params and
    state by name."""
    graph_ = hasattr(jnet, "layer_vertices")
    conf_cls = (neural_net.ComputationGraphConfiguration if graph_
                else neural_net.MultiLayerConfiguration)
    cls = ComputationGraph if graph_ else MultiLayerNetwork
    return cls(conf_cls.from_json(jnet.conf.to_json()), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_np_tree(jnet.state or {})), **init)


def _pair(kind, setup, **kw):
    """(reference base, reference tuned, port tuned from the reference's,
    port base from the reference base)."""
    jbase = NETS[kind](JAX, **kw)
    jnet = setup(JAX.TL(jbase)).build()
    return jbase, jnet, _port_of(jnet), _port_of(jbase)


def _leaves(net):
    return {(v, k): t.detach().clone()
            for v, p in net.params_tree.items() for k, t in p.items()}


def _opt_structure(opt):
    return {v: (() if isinstance(s, tuple) and not s else
                {f: sorted(names) for f, names in s.items()})
            for v, s in opt.items() if not v.startswith("_")}


def _assert_trees(ptree, jtree, tol, names=None):
    assert sorted(ptree) == sorted(k for k in jtree
                                   if isinstance(jtree[k], dict))
    for v, lp in jtree.items():
        if not isinstance(lp, dict):
            continue
        assert sorted(ptree[v]) == sorted(lp), v
        for k, a in lp.items():
            if names is not None and not names(k):
                continue
            got = ptree[v][k].detach()
            if got.dtype == torch.bfloat16:
                got = got.float()
            want = np.asarray(a)
            if want.dtype.name == "bfloat16":
                want = want.astype(np.float32)
            np.testing.assert_allclose(got.numpy(), want, **tol,
                                       err_msg=f"{v}/{k}")


SETUPS = {
    "freeze": lambda tl: tl.freeze_up_to(1),
    "lora": lambda tl: tl.add_lora(rank=2, alpha=4),
    "mixed": lambda tl: tl.freeze(0).add_lora(rank=3, layers=[1, 2]),
}


# ------------------------------------------------------- spec and build

@pytest.mark.parametrize("kind", ["mlp", "graph"])
@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_spec_split_merge_and_build_equal_the_reference(kind, setup):
    jbase, jnet, pnet, pbase = _pair(kind, SETUPS[setup])
    assert pnet._frozen_spec == jnet._frozen_spec
    assert _opt_structure(pnet.opt_state) == _opt_structure(jnet.opt_state)
    # The port's own builder: the same stamped conf, names and spec.
    ptuned = SETUPS[setup](transfer.TransferLearning(pbase)).build()
    assert json.loads(ptuned.conf.to_json()) == json.loads(
        jnet.conf.to_json())
    assert ptuned._frozen_spec == jnet._frozen_spec
    assert {v: sorted(p) for v, p in ptuned.params_tree.items()} == {
        v: sorted(p) for v, p in jnet.params_tree.items()}
    for v, p in ptuned.params_tree.items():
        for k, t in p.items():
            assert t.requires_grad == (k not in ptuned._frozen_spec.get(
                v, ())), (v, k)
            if not lora.is_lora_leaf(k):
                assert torch.equal(t.detach(), pbase.params_tree[v][k])
    # split / merge: the reference's halves, and back to the same tensors.
    ptr, pfr = transfer.split_tree(ptuned.params_tree, ptuned._frozen_spec)
    jtr, jfr = jax_transfer.split_tree(jnet.params_tree, jnet._frozen_spec)
    assert {v: sorted(p) for v, p in ptr.items()} == {
        v: sorted(p) for v, p in jtr.items()}
    assert {v: sorted(p) for v, p in pfr.items()} == {
        v: sorted(p) for v, p in jfr.items()}
    back = transfer.merge_tree(ptr, pfr)
    assert all(back[v][k] is t for v, p in ptuned.params_tree.items()
               for k, t in p.items())
    assert transfer._layer_items(ptuned) and [
        k for k, _ in transfer._layer_items(ptuned)] == [
        k for k, _ in jax_transfer._layer_items(jnet)]


def test_lora_params_and_init_stream():
    net = mlp(PORT)
    tuned = transfer.TransferLearning(net).add_lora(rank=4, alpha=8).build()
    lp = tuned.params_tree["layer_0"]
    assert tuple(lp["W__lora_a"].shape) == (5, 4)
    assert tuple(lp["W__lora_b"].shape) == (4, 8)
    assert not lp["W__lora_b"].any()
    assert lp["W__lora_scale"].dtype == torch.float32
    assert float(lp["W__lora_scale"]) == 2.0
    a = torch.cat([p["W__lora_a"].detach().reshape(-1)
                   for p in tuned.params_tree.values()])
    assert abs(float(a.std()) - 0.02) < 0.006 and abs(float(a.mean())) < 0.01
    # A conf that carries lora_rank draws its factors from a stream of
    # their own: the base draws are the plain conf's.
    plain = mlp(PORT)
    fresh = MultiLayerNetwork(tuned.conf, device="cpu").init()
    for v, p in plain.params_tree.items():
        for k, t in p.items():
            assert torch.equal(t, fresh.params_tree[v][k]), (v, k)
    assert lora.adapter_rank(lora.extract_adapter(fresh.params_tree)) == 4
    assert fresh.num_params() == plain.num_params()


def test_add_lora_and_freeze_errors():
    def conv(ns):
        return ns.MLN(
            _builder(ns).list()
            .layer(ns.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(ns.L.OutputLayer(n_out=3))
            .set_input_type(ns.I.convolutional(6, 6, 2)).build()).init()

    for ns in (JAX, PORT):
        tl = ns.TL(conv(ns))
        with pytest.raises(ValueError, match="no 2-D weight to adapt"):
            tl.add_lora(rank=2, layers=[0])
        with pytest.raises(ValueError, match="rank must be positive"):
            tl.add_lora(rank=0)
        with pytest.raises(ValueError, match="out of range"):
            tl.freeze(5)
        with pytest.raises(ValueError, match="unknown layer"):
            tl.freeze("nope")
        tuned = tl.add_lora(rank=2).build()  # the output layer only
        assert sorted(tuned._frozen_spec) == ["layer_1"]
        assert not any(lora.is_lora_leaf(k)
                       for k in tuned.params_tree["layer_0"])
    with pytest.raises(ValueError, match="initialized"):
        transfer.TransferLearning(types.SimpleNamespace(params_tree=None))


def test_source_net_never_mutated():
    base = mlp(PORT)
    before, conf = _leaves(base), base.conf.to_json()
    opt = base.updater_state_flat().copy()
    tuned = (transfer.TransferLearning(base).freeze(0).add_lora(rank=2)
             .build())
    x, y = _data("mlp")
    for _ in range(2):
        tuned.fit(DataSet(x, y))
    assert base.conf.to_json() == conf
    assert all(torch.equal(t, _leaves(base)[key])
               for key, t in before.items())
    assert np.array_equal(base.updater_state_flat(), opt)
    assert not any(t is base.params_tree[v][k]
                   for v, p in tuned.params_tree.items()
                   for k, t in p.items() if k in base.params_tree[v])


# ---------------------------------------------------------------- training

@pytest.mark.parametrize("kind", ["mlp", "graph"])
def test_freezing_trains_as_the_reference(kind):
    _, jnet, pnet, _ = _pair(kind, SETUPS["freeze"])
    frozen = [v for v, s in jnet.opt_state.items() if s == ()]
    assert len(frozen) == 2
    before = _leaves(pnet)
    x, y = _data(kind)
    for step in range(3):
        _fit(jnet, kind, x, y, True)
        _fit(pnet, kind, x, y, False)
        np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                                   **STEPS)
    for (v, k), t in before.items():
        if v in frozen:
            assert torch.equal(t, pnet.params_tree[v][k]), (v, k)
    assert _opt_structure(pnet.opt_state) == _opt_structure(jnet.opt_state)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **STEPS)
    _assert_trees(pnet.params_tree, jnet.params_tree, STEPS)


@pytest.mark.parametrize("kind", ["mlp", "graph", "lstm"])
def test_lora_fit_equals_the_reference(kind):
    jbase, jnet, pnet, pbase = _pair(kind, SETUPS["lora"])
    x, y = _data(kind)
    # B = 0: the first forward is the base's.
    np.testing.assert_allclose(_out(pnet, kind, x), _out(pbase, kind, x),
                               **F32)
    before = _leaves(pnet)
    for _ in range(3):
        _fit(jnet, kind, x, y, True)
        _fit(pnet, kind, x, y, False)
        np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                                   **STEPS)
    _assert_trees(pnet.params_tree, jnet.params_tree, STEPS)
    assert _opt_structure(pnet.opt_state) == _opt_structure(jnet.opt_state)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **STEPS)
    for (v, k), t in before.items():
        if not k.endswith((lora.LORA_A, lora.LORA_B)):
            assert torch.equal(t, pnet.params_tree[v][k]), (v, k)
    # The inference copy follows the steps: output sees the new A and B.
    np.testing.assert_allclose(_out(pnet, kind, x), _out(jnet, kind, x),
                               **STEPS)
    assert np.abs(_out(pnet, kind, x) - _out(pbase, kind, x)).max() > 1e-4


@pytest.mark.parametrize("kind", ["mlp", "graph"])
def test_output_with_params_equals_the_reference(kind):
    jbase, jnet, pnet, pbase = _pair(kind, SETUPS["lora"])
    x, y = _data(kind)
    for _ in range(2):
        _fit(jnet, kind, x, y, True)
    jad = jax_transfer.lora_mod.extract_adapter(jnet.params_tree)
    jmerged = jax_transfer.lora_mod.merge_adapter(jbase.params_tree, jad)
    want = _out(jbase, kind, x, params=jmerged)
    ad = {v: {k: torch.as_tensor(np.array(a)) for k, a in p.items()}
          for v, p in jad.items()}
    merged = lora.merge_adapter(pbase.params_tree, ad)
    plain = _out(pbase, kind, x)  # fills the inference copy
    np.testing.assert_allclose(_out(pbase, kind, x, params=merged), want,
                               **F32)
    # The override never reads or fills the cache.
    np.testing.assert_array_equal(_out(pbase, kind, x), plain)
    assert all(merged[v][k] is t for v, p in pbase.params_tree.items()
               for k, t in p.items())


def test_lora_over_int8_equals_the_reference():
    jbase = mlp(JAX)
    jax_quantize.quantize_net(jbase)
    jnet = JAX.TL(jbase).add_lora(rank=2, alpha=4).build()
    pnet = _port_of(jnet)
    assert pnet.params_tree["layer_0"]["W"].dtype == torch.int8
    x, y = _data("mlp")
    np.testing.assert_allclose(_out(pnet, "mlp", x), _out(jnet, "mlp", x),
                               **F32)
    before = _leaves(pnet)
    for _ in range(3):
        _fit(jnet, "mlp", x, y, True)
        _fit(pnet, "mlp", x, y, False)
        np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                                   **STEPS)
    _assert_trees(pnet.params_tree, jnet.params_tree, STEPS,
                  names=lambda k: k.endswith((lora.LORA_A, lora.LORA_B)))
    for (v, k), t in before.items():
        if not k.endswith((lora.LORA_A, lora.LORA_B)):
            assert torch.equal(t, pnet.params_tree[v][k]), (v, k)
    np.testing.assert_allclose(_out(pnet, "mlp", x), _out(jnet, "mlp", x),
                               **STEPS)
    # The port's own path: quantize, then LoRA over it, trains; an int8
    # leaf that would train is still refused.
    q = quantize.quantize_net(mlp(PORT))
    with pytest.raises(ValueError, match="post-training-quantized"):
        q.fit(DataSet(x, y))
    tuned = transfer.TransferLearning(q).add_lora(rank=2).build()
    tuned.fit(DataSet(x, y))
    assert np.isfinite(tuned.score_value)
    partial = transfer.TransferLearning(q).add_lora(rank=2, layers=[0])
    with pytest.raises(ValueError, match="post-training-quantized"):
        partial.build().fit(DataSet(x, y))


def test_truncated_bptt_under_a_spec():
    def setup(tl):
        return tl.add_lora(rank=2, layers=[0]).freeze(1)

    def net(ns):
        return ns.MLN(
            _builder(ns).list()
            .layer(ns.L.GravesLSTM(n_out=6, activation="tanh"))
            .layer(ns.L.RnnOutputLayer(n_out=3, activation="softmax",
                                       loss_function="mcxent"))
            .set_input_type(ns.I.recurrent(4))
            .backprop_type("truncatedbptt").t_bptt_forward_length(3)
            .t_bptt_backward_length(3).build()).init()

    jnet = setup(JAX.TL(net(JAX))).build()
    pnet = _port_of(jnet)
    assert pnet._tbptt()
    x, y = _data("lstm", t=8)
    before = _leaves(pnet)
    for _ in range(2):
        jnet.fit(JDataSet(x, y))
        pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                               **CHUNKS)
    _assert_trees(pnet.params_tree, jnet.params_tree, CHUNKS)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **CHUNKS)
    assert pnet.opt_state["layer_1"] == () and pnet.iteration == 2
    for (v, k), t in before.items():
        if not k.endswith((lora.LORA_A, lora.LORA_B)):
            assert torch.equal(t, pnet.params_tree[v][k]), (v, k)


def test_superstep_under_a_spec():
    jnet = SETUPS["mixed"](JAX.TL(mlp(JAX, superstep_k=2))).build()
    pnet = _port_of(jnet)
    per_batch = _port_of(jnet)
    per_batch._global.superstep_k = 0
    assert pnet._superstep_k() == 2 and per_batch._superstep_k() == 0
    batches = [_data("mlp", seed=s) for s in range(4)]
    jnet.fit([JDataSet(x, y) for x, y in batches])
    pnet.fit([DataSet(x, y) for x, y in batches])
    per_batch.fit([DataSet(x, y) for x, y in batches])
    assert pnet.iteration == per_batch.iteration == 4
    for v, p in pnet.params_tree.items():
        for k, t in p.items():
            assert torch.equal(t, per_batch.params_tree[v][k]), (v, k)
    _assert_trees(pnet.params_tree, jnet.params_tree, STEPS)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **STEPS)


@pytest.mark.parametrize("setup", ["freeze", "mixed"])
def test_low_precision_masters_under_a_spec(setup):
    """bf16 params with f32 masters: frozen stored leaves and their
    masters keep their bits. Against the reference for frozen layers; a
    LoRA net under this policy the reference cannot step (its adapter
    leaves are f32 in both the params and the masters, one buffer donated
    twice: ROADMAP C), so there the port is held to its invariants and to
    the reference's first forward."""
    jnet = SETUPS[setup](JAX.TL(mlp(JAX, policy="bfloat16"))).build()
    pnet = _port_of(jnet)
    assert pnet.dtype_policy.low_precision_params
    frozen = pnet._frozen_spec
    stored, masters = _leaves(pnet), {
        (v, k): t.clone() for v, p in pnet.opt_state["_master"].items()
        for k, t in p.items()}
    x, y = _data("mlp")
    np.testing.assert_allclose(_out(pnet, "mlp", x), _out(jnet, "mlp", x),
                               **BF16)
    for _ in range(2):
        if setup == "freeze":
            _fit(jnet, "mlp", x, y, True)
        _fit(pnet, "mlp", x, y, False)
    assert np.isfinite(pnet.score_value)
    for (v, k), t in stored.items():
        if k in frozen.get(v, ()):
            assert torch.equal(t, pnet.params_tree[v][k]), (v, k)
            assert torch.equal(masters[(v, k)],
                               pnet.opt_state["_master"][v][k]), (v, k)
        elif k.endswith(lora.LORA_B):  # trained, through the masters
            assert pnet.params_tree[v][k].dtype == torch.bfloat16
            assert pnet.opt_state["_master"][v][k].any()
    assert _opt_structure(pnet.opt_state) == _opt_structure(jnet.opt_state)
    if setup == "freeze":
        np.testing.assert_allclose(pnet.score_value,
                                   float(jnet.score_value), **BF16)
        _assert_trees(pnet.opt_state["_master"], jnet.opt_state["_master"],
                      BF16)


def test_clone_keeps_the_spec_and_steps_alike():
    tuned = transfer.TransferLearning(mlp(PORT)).freeze(0).add_lora(
        rank=2, layers=[1, 2]).build()
    x, y = _data("mlp")
    tuned.fit(DataSet(x, y))
    twin = tuned.clone()
    assert twin._frozen_spec == tuned._frozen_spec
    assert _opt_structure(twin.opt_state) == _opt_structure(tuned.opt_state)
    for net in (tuned, twin):
        net.fit(DataSet(x, y))
    for v, p in tuned.params_tree.items():
        for k, t in p.items():
            assert torch.equal(t, twin.params_tree[v][k]), (v, k)
    assert np.array_equal(tuned.updater_state_flat(),
                          twin.updater_state_flat())


# ------------------------------------------------------------- persistence

def test_model_zip_of_a_lora_net_matches_the_reference(tmp_path):
    """The zip holds the flat `param_shapes()` view, which has no LoRA
    leaf: a LoRA net reloaded from a zip computes its base function in
    both packages (the reference's `set_params` drops the leaves; the
    port keeps fresh ones with B = 0), with the same flat params and
    updater state."""
    jbase, jnet, pnet, pbase = _pair("mlp", SETUPS["mixed"])
    x, y = _data("mlp")
    for _ in range(2):
        _fit(jnet, "mlp", x, y, True)
        _fit(pnet, "mlp", x, y, False)
    jpath, ppath = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jax_serializer.save_model(jnet, jpath)
    model_serializer.save_model(pnet, ppath)
    jback = jax_serializer.load_model(jpath)
    base_out = _out(pbase, "mlp", x)
    assert not any(lora.is_lora_leaf(k)
                   for p in jback.params_tree.values() for k in p)
    np.testing.assert_allclose(_out(jback, "mlp", x), base_out, **F32)
    for path in (jpath, ppath):
        back = model_serializer.load_model(path, device="cpu")
        assert back._frozen_spec == jnet._frozen_spec
        np.testing.assert_allclose(back.output(x), base_out, **F32)
        np.testing.assert_allclose(back.params(), np.asarray(jback.params()),
                                   **STEPS)
        np.testing.assert_allclose(back.updater_state_flat(),
                                   np.asarray(jback.updater_state_flat()),
                                   **STEPS)


def test_sharded_checkpoint_keeps_the_adapter_in_both_packages(tmp_path):
    _, jnet, pnet, _ = _pair("graph", SETUPS["mixed"])
    x, y = _data("graph")
    _fit(pnet, "graph", x, y, False)
    _fit(jnet, "graph", x, y, True)
    ppath, jpath = str(tmp_path / "p"), str(tmp_path / "j")
    store.save_checkpoint(pnet, ppath)
    jax_store.save_checkpoint(jnet, jpath)
    from_port = jax_store.restore_checkpoint(ppath)
    from_ref = store.restore_checkpoint(jpath, device="cpu")
    _assert_trees(pnet.params_tree, from_port.params_tree,
                  dict(rtol=0, atol=0))
    assert from_ref._frozen_spec == jnet._frozen_spec
    _assert_trees(from_ref.params_tree, jnet.params_tree,
                  dict(rtol=0, atol=0))
    np.testing.assert_array_equal(from_ref.updater_state_flat(),
                                  np.asarray(jnet.updater_state_flat()))
    np.testing.assert_allclose(_out(from_ref, "graph", x),
                               _out(jnet, "graph", x), **F32)


def _trunk(ns):
    gb = (_builder(ns, updater="nesterovs").momentum(0.9).weight_init("relu")
          .graph_builder().add_inputs("in"))
    gb.add_layer("stem", ns.L.ConvolutionLayer(
        kernel_size=(3, 3), n_out=16, convolution_mode="same",
        activation="identity"), "in")
    gb.add_layer("bn", ns.L.BatchNormalization(activation="relu"), "stem")
    gb.add_layer("b1", ns.L.BottleneckBlock(filters=4, stride=(2, 2),
                                            project=True), "bn")
    gb.add_layer("b2", ns.L.BottleneckBlock(filters=4), "b1")
    gb.add_layer("pool", ns.L.GlobalPoolingLayer(pooling_type="avg"), "b2")
    gb.add_layer("out", ns.L.OutputLayer(n_out=3, activation="softmax",
                                         loss_function="mcxent"), "pool")
    return ns.CG(gb.set_outputs("out")
                 .set_input_types(ns.I.convolutional(8, 8, 3)).build()).init()


def test_frozen_trunk_runs_in_training_mode_as_the_reference():
    """A frozen BatchNorm and bottleneck trunk under a trained head: the
    trunk's params keep their bits, its layers still run in training mode
    (batch statistics), so the running statistics move as the
    reference's do, and only the head's two tensors have updater
    state."""
    jbase = _trunk(JAX)
    jnet = JAX.TL(jbase).freeze_up_to("b2").build()
    pnet = _port_of(jnet)
    assert {v for v, s in pnet.opt_state.items() if s == ()} == {
        "stem", "bn", "b1", "b2"}
    rng = np.random.RandomState(4)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    before, state0 = _leaves(pnet), {
        (v, k): t.clone() for v, s in pnet.state.items()
        for k, t in s.items()}
    for _ in range(2):
        _fit(jnet, "graph", x, y, True)
        _fit(pnet, "graph", x, y, False)
    np.testing.assert_allclose(pnet.score_value, float(jnet.score_value),
                               **STEPS)
    for (v, k), t in before.items():
        if v != "out":
            assert torch.equal(t, pnet.params_tree[v][k]), (v, k)
    assert all(not torch.equal(t, pnet.state[v][k])
               for (v, k), t in state0.items())
    _assert_trees(pnet.state, jnet.state, STEPS)
    _assert_trees(pnet.params_tree, jnet.params_tree, STEPS)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **STEPS)
