"""Float64 nets in both packages, on the CPU: the port's float64 path
(every kernel's plain version in double, the engine keeping f64 params,
grads, updater state, lse and D) against the JAX package run in float64
(x64 is on for the whole suite, `tests/conftest.py`), as
`tests/test_torch_gradientcheck.py` runs it.

Nets, each carried over with `to_json()` -> `from_json` and
`params_from_numpy` (f64 leaves stay f64):
- `transformer_lm(V=64, t=32, d_model=32, n_heads=4, n_blocks=2)`, Adam:
  `output`, one `fit` step (score, params, m, v), and its cached greedy
  ids (`decode_cache_length=32`) against the JAX `generate_lm(use_cache=
  True)`; and the same LM at t=64 with the port's resident limit patched
  to 0, so its streamed plain versions (rows 4 and 7) run;
- a graph of two fused bottleneck blocks (identity and projecting), a
  global pool and a softmax output, Nesterovs: `output`, one `fit` step
  and the BatchNorm running statistics;
- LeNet (`lenet_mnist`), Nesterovs: `output`, one `fit` step and the
  velocity;
- the char-RNN (`char_rnn`, 2 GravesLSTMs of 16, tBPTT 5 over 12 steps),
  RMSProp: `output` and one `fit` (three chunks) and g2.

Tolerance: 1e-10 relative, each tensor's largest |got - want| over its
largest |want|. The two frameworks sum in other orders (XLA's dot and
conv emitters against PyTorch's), so the bits differ. The largest errors
measured on this CPU: 1.3e-13 (the char-RNN's RMSProp step, its
near-zero gradients divided by sqrt(g2)), 1.0e-14 (the bottleneck graph),
3.0e-15 (the LM, resident or streamed) and 1.8e-15 (LeNet); so 1e-10
leaves nearly three orders of room, and f32 anywhere on the path (an f32
lse, an f32 Adam constant) fails it by three or more.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

REL = 1e-10


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


def _np(a):
    return a.detach().numpy() if hasattr(a, "detach") else np.array(a)


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {v: ({f: {k: np.array(a) for k, a in s.items()}
                 for f, s in p.items()} if isinstance(next(iter(p.values()),
                                                           None), dict)
                else {k: np.array(a) for k, a in p.items()})
            for v, p in tree.items() if isinstance(p, dict)}


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / scale


def _close(got, want, what=""):
    err = _rel(got, want)
    assert err <= REL, f"{what}: {err}"


def _trees_close(port_tree, jax_tree, what):
    for v, p in jax_tree.items():
        for k, a in p.items():
            got = port_tree[v][k]
            assert got.dtype == torch.float64, f"{what} {v}/{k}: {got.dtype}"
            _close(got, a, f"{what} {v}/{k}")


def _graph(jconf, params, state=None, **kw):
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    return ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(params),
        **({} if state is None else
           {"state": interop.state_from_numpy(state)}), **kw)


def _mln(jconf, params):
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    return MultiLayerNetwork(conf, device="cpu").init(
        params=interop.params_from_numpy(params))


# ------------------------------------------------------------------ LM

V, D, H, NB, B = 64, 32, 4, 2, 2


def _ids(t, seed=0):
    ids = np.random.RandomState(seed).randint(0, V, (B, t + 1))
    return ids[:, :-1, None].astype(np.float64), ids[:, 1:].astype(np.int32)


def _lm_pair(t, **kw):
    jconf = jax_zoo.transformer_lm(V, t=t, d_model=D, n_heads=H,
                                   n_blocks=NB, dtype="float64", **kw)
    jnet = JaxGraph(jconf).init()
    pnet = _graph(jconf, _np_tree(jnet.params_tree))
    return jnet, pnet


@pytest.mark.parametrize("streamed", [False, True])
def test_lm_output_and_fit_step_in_f64(monkeypatch, streamed):
    t = 64 if streamed else 32
    if streamed:
        monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    jnet, pnet = _lm_pair(t)
    assert pnet.dtype_policy.param_dtype == torch.float64
    x, y = _ids(t)
    kernels.reset_counts()
    _close(pnet.output(x)[0], jnet.output(x)[0], "output")
    jnet.fit(JaxMDS([x], [y]))
    pnet.fit(MultiDataSet([x], [y]))
    _close(pnet.score_value, jnet.score_value, "score")
    _trees_close(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    jopt = _np_tree(jnet.opt_state)
    for f in ("m", "v"):
        _trees_close({v: s[f] for v, s in pnet.opt_state.items()},
                     {v: s[f] for v, s in jopt.items()}, f)
    plain = kernels.counts()["plain_calls"]
    if streamed:
        assert plain["flash_attention_stream"] == 2 * NB  # output, fit
        assert plain["flash_attention_bwd_dq_stream"] == NB
        assert plain["flash_attention_fwd_lse"] == 0
    else:
        assert plain["flash_attention"] == NB
        assert plain["flash_attention_fwd_lse"] == NB
        assert plain["flash_attention_bwd_dkv"] == NB
        assert plain["flash_attention_stream"] == 0


def test_lm_lse_and_drow_stay_f64():
    rng = np.random.RandomState(1)
    q, k, v, do = (torch.tensor(rng.randn(1, 9, 2, 8)) for _ in range(4))
    o, lse = fa.dense_attention_lse(q, k, v, True)
    assert lse.dtype == torch.float64
    assert fa._drow(o, do).dtype == torch.float64
    _, lse_s = fa.flash_stream_fwd_plain(q, k, v, True, 8 ** -0.5)
    assert lse_s.dtype == torch.float64
    _close(lse_s, lse)


def test_lm_cached_greedy_ids_in_f64():
    jconf = jax_zoo.transformer_lm(V, t=16, d_model=D, n_heads=H,
                                   n_blocks=NB, dtype="float64",
                                   decode_cache_length=32)
    jnet = JaxGraph(jconf).init()
    pnet = _graph(jconf, _np_tree(jnet.params_tree))
    prompt = [3, 17, 42, 5, 9]
    want = jax_zoo.generate_lm(jnet, prompt, 12, window=32, temperature=0.0,
                               use_cache=True)
    got = zoo.generate_lm(pnet, prompt, 12, window=32, temperature=0.0,
                          use_cache=True)
    assert got == want
    assert len(got) == len(prompt) + 12


# ---------------------------------------------------- fused bottleneck

def _bottleneck_conf():
    gb = (JaxNNC.builder().seed(7).learning_rate(0.05).updater("nesterovs")
          .momentum(0.9).weight_init("relu").dtype("float64")
          .graph_builder().add_inputs("input"))
    gb.add_layer("b1", JL.BottleneckBlock(filters=4, stride=(2, 2),
                                          project=True), "input")
    gb.add_layer("b2", JL.BottleneckBlock(filters=4), "b1")
    gb.add_layer("pool", JL.GlobalPoolingLayer(pooling_type="avg"), "b2")
    gb.add_layer("out", JL.OutputLayer(n_out=3, activation="softmax",
                                       loss_function="mcxent"), "pool")
    return (gb.set_outputs("out")
            .set_input_types(JaxInputType.convolutional(8, 8, 16)).build())


def test_fused_bottleneck_graph_in_f64():
    jconf = _bottleneck_conf()
    jnet = JaxGraph(jconf).init()
    pnet = _graph(jconf, _np_tree(jnet.params_tree),
                  state=_np_tree(jnet.state))
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 8, 16)
    y = np.eye(3)[rng.randint(0, 3, 4)]
    kernels.reset_counts()
    _close(pnet.output(x)[0], jnet.output(x)[0], "output")
    jnet.fit(JaxMDS([x], [y]))
    pnet.fit(MultiDataSet([x], [y]))
    _close(pnet.score_value, jnet.score_value, "score")
    _trees_close(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    _trees_close(pnet.state, _np_tree(jnet.state), "running stats")
    jopt = _np_tree(jnet.opt_state)
    _trees_close({v: s["v"] for v, s in pnet.opt_state.items() if s},
                 {v: s["v"] for v, s in jopt.items() if s}, "velocity")
    plain = kernels.counts()["plain_calls"]
    assert plain["bottleneck_train"] == 2 and plain["bottleneck_infer"] == 2


# ---------------------------------------------------------------- LeNet

def test_lenet_nesterovs_step_in_f64():
    jconf = jax_zoo.lenet_mnist(dtype="float64")
    jnet = JaxMLN(jconf).init()
    pnet = _mln(jconf, _np_tree(jnet.params_tree))
    rng = np.random.RandomState(3)
    x = rng.rand(4, 28, 28, 1)
    y = np.eye(10)[rng.randint(0, 10, 4)]
    _close(pnet.output(x), jnet.output(x), "output")
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    _close(pnet.score_value, jnet.score_value, "score")
    _trees_close(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    jopt = _np_tree(jnet.opt_state)
    _trees_close({v: s["v"] for v, s in pnet.opt_state.items() if s},
                 {v: s["v"] for v, s in jopt.items() if s}, "velocity")


# ------------------------------------------------------------- char-RNN

def test_char_rnn_rmsprop_in_f64():
    jconf = jax_zoo.char_rnn(vocab_size=10, hidden=16, layers=2,
                             tbptt_length=5, dtype="float64")
    jnet = JaxMLN(jconf).init()
    pnet = _mln(jconf, _np_tree(jnet.params_tree))
    rng = np.random.RandomState(4)
    x = np.eye(10)[rng.randint(0, 10, (3, 12))]
    y = np.eye(10)[rng.randint(0, 10, (3, 12))]
    _close(pnet.output(x), jnet.output(x), "output")
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    _close(pnet.score_value, jnet.score_value, "score")
    _trees_close(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    jopt = _np_tree(jnet.opt_state)
    _trees_close({v: s["g2"] for v, s in pnet.opt_state.items() if s},
                 {v: s["g2"] for v, s in jopt.items() if s}, "g2")


# ---------------------------------------------------------- persistence

def test_f64_net_round_trips_zip_and_checkpoint(tmp_path):
    # A float64 net saved through the model zip and the sharded store
    # comes back float64 and equal, updater state included.
    from deeplearning4j_tpu_torch.checkpoint import store
    from deeplearning4j_tpu_torch.util import model_serializer

    net = MultiLayerNetwork(zoo.lenet_mnist(dtype="float64"),
                            device="cpu").init()
    rng = np.random.RandomState(5)
    x = rng.rand(4, 28, 28, 1)
    net.fit(DataSet(x, np.eye(10)[rng.randint(0, 10, 4)]))
    zip_path = str(tmp_path / "lenet64.zip")
    model_serializer.save_model(net, zip_path)
    ckpt = store.save_checkpoint(net, str(tmp_path / "ckpt" / "step_1"))
    for back in (model_serializer.load_model(zip_path, device="cpu"),
                 store.restore_checkpoint(ckpt, device="cpu")):
        for v, p in net.params_tree.items():
            for k, a in p.items():
                got = back.params_tree[v][k]
                assert got.dtype == torch.float64
                assert torch.equal(got, a)
        for v, s in net.opt_state.items():
            for f, leaves in (s or {}).items():
                for k, a in leaves.items():
                    assert back.opt_state[v][f][k].dtype == torch.float64
                    assert torch.equal(back.opt_state[v][f][k], a)
        np.testing.assert_array_equal(back.output(x), net.output(x))
