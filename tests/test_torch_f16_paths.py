"""The f16 paths of the port against the JAX package, on the CPU: what the
card now runs in f16 through rows 2, 4, 7, 8, 10, 11 and 12, driven here
through the kernels' plain versions.

- A small conv + BatchNorm stem and a projecting fused bottleneck block
  (rows 2, 11) under mixed_float16: one step, then a step forced
  non-finite; the score, the f32 params, the BatchNorm running statistics
  (kept f32) and the loss-scale pair (the skip decision) against the
  reference's.
- The character graph of `CompGraphLSTMExample` (row 10) with truncated
  BPTT under mixed_float16: one single-chunk step (score within 4u), then
  one `fit` of three chunks, each its own step with its own skip
  decision, held within the sign-flip bound of
  `tests/test_torch_precision_slice.py`'s tBPTT char-RNN.
- A V=64 LM under mixed_float16 behind the paged `InferenceServer` (rows
  1, 3, 8): f16 pages, greedy ids equal to the reference's
  `generate_lm(use_cache=True)`, and a speculative round with a twin draft
  giving the same ids.

Tolerances as `tests/test_torch_precision_slice.py` sets them for
low-precision compute (u = 2^-11, f16's unit roundoff; the frameworks round
at other places): the score rtol 4u; f32 leaves rtol 2e-4 and atol
2 n lr u plus the first Nesterovs step's sign flips; the loss-scale pair
equal.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import resnet as jax_resnet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import dtype_policy as jax_policy
from deeplearning4j_tpu.nn.conf import graph as jax_graph
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
from deeplearning4j_tpu_torch.nn.conf import graph, layers
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import DtypePolicy
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import InferenceServer
from test_torch_graph_tbptt import char_graph_conf
from test_torch_precision_slice import _small_bottleneck

U = 2.0 ** -11


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_model_zip.py`)."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.array(a, np.float32)


def _tree(tree):
    """A reference tree as nested numpy, copied (its step donates)."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return np.array(tree)


def _ls(net):
    return [float(t) for t in net.opt_state["_ls"]]


def _port_of(jnet):
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    return ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(_tree(jnet.params_tree)),
        state=interop.state_from_numpy(_tree(jnet.state)))


def test_bottleneck_and_batchnorm_graph_under_mixed_float16():
    jconf = _small_bottleneck((JaxNNC, jax_layers, JaxInputType,
                               jax_resnet))
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(
        {"name": "mixed_float16", "initial_loss_scale": 1024.0})
    jnet = JaxGraph(jconf).init()
    net = _port_of(jnet)
    assert net.dtype_policy.name == "mixed_float16"
    rng = np.random.RandomState(8)
    x = rng.randn(4, 12, 12, 3).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 4)]
    kernels.reset_counts()
    jnet.fit(JaxMDS([x], [y]))
    net.fit(MultiDataSet([x], [y]))
    plain = kernels.counts()["plain_calls"]
    assert plain["batchnorm_norm_act"] == 1 and plain["bottleneck_train"] == 1
    assert _ls(net) == _ls(jnet) == [1024.0, 1.0]
    np.testing.assert_allclose(net.score_value, jnet.score_value, rtol=4 * U)
    lr = float(jconf.global_conf.learning_rate)
    # Nesterovs' first step moves a param by ~1.9 lr g: f16 rounding of g
    # (u relative, up to 4u over the block's chain) moves it by a few
    # ulps of lr g; the f32 leaves at rtol 2e-4 and atol 8 lr u max|g|,
    # with max|g| bounded by the step itself.
    for v, p in jnet.params_tree.items():
        for k, a in p.items():
            got, want = _np(net.params_tree[v][k]), _np(a)
            assert net.params_tree[v][k].dtype == torch.float32
            np.testing.assert_allclose(got, want, rtol=2e-4,
                                       atol=8 * lr * U + 1e-6,
                                       err_msg=f"{v}/{k}")
    # The running statistics stay f32, and agree to f16's rounding.
    for v, s in jnet.state.items():
        for k, a in s.items():
            assert net.state[v][k].dtype == torch.float32, (v, k)
            np.testing.assert_allclose(_np(net.state[v][k]), _np(a),
                                       rtol=4 * U, atol=4 * U,
                                       err_msg=f"state {v}/{k}")
    # A step forced non-finite: both skip it, params and state unchanged,
    # the scale halved.
    before = {v: {k: t.detach().clone() for k, t in p.items()}
              for v, p in net.params_tree.items()}
    state = {v: {k: t.clone() for k, t in s.items()}
             for v, s in net.state.items()}
    net.opt_state["_ls"][0].fill_(2.0 ** 100)
    jnet.opt_state["_ls"] = (jnet.opt_state["_ls"][0] * 0 + 2.0 ** 100,
                             jnet.opt_state["_ls"][1])
    jnet.fit(JaxMDS([x], [y]))
    net.fit(MultiDataSet([x], [y]))
    assert _ls(net) == _ls(jnet) == [2.0 ** 99, 0.0]
    assert all(torch.equal(net.params_tree[v][k].detach(), t)
               for v, p in before.items() for k, t in p.items())
    assert all(torch.equal(net.state[v][k], t)
               for v, s in state.items() for k, t in s.items())


def test_char_graph_tbptt_under_mixed_float16():
    kw = dict(n=16, vocab=11, fwd=5)
    jconf = char_graph_conf(JaxNNC.builder, jax_layers, JaxInputType,
                            jax_graph, **kw)
    pconf = char_graph_conf(NeuralNetConfiguration.builder, layers,
                            InputType, graph, **kw)
    policy = {"name": "mixed_float16", "initial_loss_scale": 16.0,
              "loss_scale_growth_interval": 3}
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(policy)
    pconf.global_conf.dtype_policy = DtypePolicy.of(policy)
    jnet = JaxGraph(jconf).init()
    net = ComputationGraph(pconf, device="cpu").init(
        params=interop.params_from_numpy(_tree(jnet.params_tree)))
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 11, (3, 14))
    x = np.eye(11, dtype=np.float32)[ids[:, :-1]]
    y = np.eye(11, dtype=np.float32)[ids[:, 1:]]
    # One chunk's step first (a sequence no longer than a chunk): the same
    # f16 step in both, its score within 4u.
    first = [dict(features=[x[:, :5]], labels=[y[:, :5]])]
    jnet.fit(JaxMDS(**first[0]))
    net.fit(MultiDataSet(**first[0]))
    np.testing.assert_allclose(net.score_value, jnet.score_value, rtol=4 * U)
    kernels.reset_counts()
    jnet.fit(JaxMDS([x], [y]))
    net.fit(MultiDataSet([x], [y]))
    # Three chunks (5, 5, 3 steps), each its own step and scale update:
    # with the first call's, 3 finite steps reach the growth interval.
    assert _ls(net) == _ls(jnet) == [32.0, 1.0]
    assert kernels.counts()["plain_calls"]["lstm_cell"] == 2 * 13
    assert net.iteration == jnet.iteration == 2 and net.state == {}
    # The last chunk's score under params that sign flips moved (below):
    # 82 of 5,067 params by more than 0.05 after these four steps, the
    # score by 0.66% (in f32 the same run agrees to 1e-6).
    np.testing.assert_allclose(net.score_value, jnet.score_value, rtol=1e-2)
    lr = float(jconf.global_conf.learning_rate)
    # The precision slice's bound for RMSProp's first f16 steps (its
    # tBPTT char-RNN test): a near-zero gradient's
    # sign may flip between the frameworks' f16 sums (2 lr / sqrt(1 -
    # decay) at most), and the mean difference stays under a quarter lr.
    d = np.concatenate([np.abs(_np(net.params_tree[v][k]) - _np(a))
                        .reshape(-1) for v, p in jnet.params_tree.items()
                        for k, a in p.items()])
    assert d.max() <= 2 * lr / np.sqrt(1 - 0.95)
    assert d.mean() <= 0.25 * lr, d.mean()


V, T, D, H, NB, CAP = 64, 16, 32, 4, 2, 64
PROMPTS = ([3, 14, 15, 9, 2], [27, 18, 28, 1, 8])
STEPS = 8
LOGIT_SCALE = 10.0  # the output projection x10: greedy with margins


def _post(url, body):
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["ids"]


def test_mixed_float16_lm_behind_the_paged_server():
    jconf = jax_zoo.transformer_lm(V, t=T, d_model=D, n_heads=H,
                                   n_blocks=NB, decode_cache_length=CAP)
    jconf.global_conf.dtype_policy = jax_policy.DtypePolicy.of(
        "mixed_float16")
    jnet = JaxGraph(jconf).init()
    tree = _tree(jnet.params_tree)
    for k in tree["out"]:
        tree["out"][k] = tree["out"][k] * LOGIT_SCALE
    import jax.numpy as jnp
    jnet.params_tree = {v: {k: jnp.asarray(a) for k, a in p.items()}
                        for v, p in tree.items()}
    want = [jax_zoo.generate_lm(jnet, p, STEPS, window=T, use_cache=True,
                                temperature=0.0) for p in PROMPTS]
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    net = ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(tree))
    twin = ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(tree))
    assert net.dtype_policy.compute_dtype == torch.float16
    for draft in (None, twin):
        server = InferenceServer(net, device="cpu", kv_cache="paged",
                                 kv_page_size=8, decode_slots=2,
                                 **({} if draft is None
                                    else {"draft": draft, "spec_k": 3}))
        server.start()
        try:
            sched = server.get(None).scheduler
            kernels.reset_counts()
            got = [_post(server.url, {"prompt_ids": p, "n_steps": STEPS,
                                      "temperature": 0}) for p in PROMPTS]
            assert got == want, (draft is not None, got, want)
            pages = [s["k_pages"] for s in sched.stepper._state.values()
                     if "k_pages" in s]
            assert pages and all(p.dtype == torch.float16 for p in pages)
            plain = kernels.counts()["plain_calls"]
            assert plain["paged_decode_attention"] > 0
            if draft is not None:
                assert sched.stats["spec_accepted"] > 0
        finally:
            server.stop()
