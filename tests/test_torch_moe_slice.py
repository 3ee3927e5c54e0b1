"""The mixture-of-experts slice in the port against the JAX package, on the
CPU: `parallel/expert.py` `moe_ffn` (routing, capacity drops, the
load-balance loss, jitter, gradients), the `MoELayer` (`nn/layers/moe.py`)
in both engines, and `zoo.transformer_lm(moe=True)` trained, run and
decoded.

The router's jitter is the port's own draw (`nn/layers/common.py`
`draw_uniform`); here it is swapped for `jax.random.uniform` at the
reference's key, and dropout's `draw_keep` for `jax.random.bernoulli`, so
both packages see the same noise. Inputs and params from seeded numpy.
Tolerances: f32 values and gradients rtol 2e-4, atol 1e-6 (sums in another
order); `fit` steps rtol 2e-4, atol 2e-5 (the training slice's: three
Adam steps carry the attention's other summation order), except the MoE
LM's params after its three steps, atol 5e-5: an expert row that few
tokens reach gets a gradient near Adam's epsilon (1e-8), where the step
lr * g / (|g| + eps) turns a rounding difference in g into a step
difference of a few percent of lr (3e-3; measured 2.6e-5 in one element
of 16,384 while its m and v agree to 3e-5 relative); routing, kept slots
and greedy ids exactly. A bf16 input is held to the reference's
bf16 call at bf16's own rounding of y (rtol 1e-2): both run the router and
the experts in f32, so only y's last rounding differs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.layers import moe as jax_moe
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.parallel import expert as jax_expert
from deeplearning4j_tpu.util import model_serializer as jax_serializer
from deeplearning4j_tpu_torch import interop
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import prng
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import common
from deeplearning4j_tpu_torch.nn.layers import moe
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import expert
from deeplearning4j_tpu_torch.util import model_serializer

F32 = dict(rtol=2e-4, atol=1e-6)
STEP = dict(rtol=2e-4, atol=2e-5)
LM_PARAMS = dict(rtol=2e-4, atol=5e-5)  # see the module docstring
V, T, D, HEADS, NB, B = 64, 32, 32, 4, 2, 2
_JNP = {torch.float32: jnp.float32, torch.float64: jnp.float64,
        torch.bfloat16: jnp.bfloat16}


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


def jax_uniform(key, low, high, shape, dtype, device):
    """The reference's jitter for the key the port draws at."""
    u = jax.random.uniform(jnp.asarray(common.key_words(key)), tuple(shape),
                           _JNP[dtype], low, high)
    return torch.from_numpy(np.array(u.astype(jnp.float32))).to(
        device, dtype)


def jax_keep(key, retain, shape, device):
    keep = jax.random.bernoulli(jnp.asarray(common.key_words(key)), retain,
                                tuple(shape))
    return torch.from_numpy(np.array(keep)).to(device)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setattr(common, "draw_uniform", jax_uniform)
    monkeypatch.setattr(common, "draw_keep", jax_keep)


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {v: ({f: {k: np.array(a) for k, a in s.items()}
                 for f, s in p.items()} if isinstance(next(iter(p.values()),
                                                           None), dict)
                else {k: np.array(a) for k, a in p.items()})
            for v, p in tree.items() if isinstance(p, dict)}


def _assert_trees(port_tree, jax_tree, what, tol):
    for v, p in jax_tree.items():
        for k, a in p.items():
            np.testing.assert_allclose(
                port_tree[v][k].detach().float().numpy(), np.asarray(a),
                err_msg=f"{what} {v}/{k}", **tol)


def _ffn_params(rng, d=8, h=16, e=4, d_out=None):
    d_out = d_out or d
    return {"gate_w": rng.randn(d, e).astype(np.float32),
            "w1": (rng.randn(e, d, h) * 0.3).astype(np.float32),
            "b1": (rng.randn(e, h) * 0.1).astype(np.float32),
            "w2": (rng.randn(e, h, d_out) * 0.3).astype(np.float32),
            "b2": (rng.randn(e, d_out) * 0.1).astype(np.float32)}


# ------------------------------------------------------------- moe_ffn

CASES = [(k, cf, j) for k in (1, 2) for cf in (1.25, 0.5) for j in (0, 0.1)]


@pytest.mark.parametrize("top_k,cf,jitter", CASES, ids=[
    f"top{k}-cf{cf}-jitter{j}" for k, cf, j in CASES])
def test_moe_ffn_matches_the_reference(top_k, cf, jitter, reference_draws):
    # Output, aux loss, routing and the gradients of a scalar of both
    # (params and x) against the reference's `moe_ffn`; without jitter
    # also against its float64 per-token loop.
    rng = np.random.RandomState(10 * top_k + int(cf * 4) + int(jitter * 10))
    p = _ffn_params(rng)
    x = rng.randn(64, 8).astype(np.float32)
    jkey = jax.random.PRNGKey(7)
    kw = dict(capacity_factor=cf, top_k=top_k, jitter_eps=jitter,
              return_aux=True)

    def jfn(pp, xx):
        y, aux = jax_expert.moe_ffn(pp, xx, rng=jkey if jitter else None,
                                    **kw)
        return (y ** 2).sum() + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jfn, argnums=(0, 1),
                                             has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    routing = []
    y, aux = expert.moe_ffn(tp, tx, rng=np.asarray(jkey) if jitter else None,
                            routing=routing, **kw)
    ((y ** 2).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **F32)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   err_msg=k, **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), **F32)
    r, = routing
    c = max(1, int(cf * top_k * 64 / 4))
    assert r.capacity == c
    kept = int(r.keep.sum())
    assert kept <= 4 * c
    if cf < 1:
        assert kept < 64 * top_k  # capacity pressure drops tokens
    if not jitter:
        want = jax_expert.dense_moe_reference(p, x, capacity_factor=cf,
                                              top_k=top_k)
        np.testing.assert_allclose(y.detach().numpy(), want, rtol=2e-4,
                                   atol=2e-5)
        logits = x.astype(np.float64) @ p["gate_w"].astype(np.float64)
        np.testing.assert_array_equal(r.expert[0].numpy(),
                                      logits.argmax(1))


def test_second_choices_queue_behind_every_first_choice():
    # Hand-made routing: 6 tokens, 2 experts, C = int(1.0 * 2 * 6 / 2) =
    # 6. Tokens 0-4 pick expert 0 first and expert 1 second, token 5 the
    # reverse: expert 1's first choice takes its slot 0, the second
    # choices follow from slot 1 in token order; expert 0's last slot goes
    # to token 5's second choice.
    gate_w = torch.tensor([[1.0, -1.0]])
    x = torch.tensor([[3.0], [2.0], [1.0], [0.5], [0.25], [-1.0]])
    r = expert.route(gate_w, x, capacity_factor=1.0, top_k=2)
    assert r.capacity == 6
    assert r.expert.tolist() == [[0, 0, 0, 0, 0, 1], [1, 1, 1, 1, 1, 0]]
    assert r.slot.tolist() == [[0, 1, 2, 3, 4, 6],
                               [7, 8, 9, 10, 11, 5]]
    assert bool(r.keep.all())
    np.testing.assert_allclose(r.gate.sum(0).numpy(), 1.0, rtol=1e-6)
    # At capacity 1 a token past its expert's first slot is dropped.
    r = expert.route(gate_w, x, capacity_factor=1.0 / 6, top_k=2)
    assert r.capacity == 1
    assert r.keep.tolist() == [[True, False, False, False, False, True],
                               [False] * 6]


def test_bf16_input_runs_the_router_and_experts_in_f32():
    # Under mixed_bfloat16 the layer gets bf16 x and bf16-rounded params:
    # the reference promotes both to f32 (`promote_types(x, f32)`) and
    # casts only y back. The port's y equals the reference's bf16 call's at
    # y's own rounding, and equals its own f32 run on the same (rounded)
    # values before that rounding.
    rng = np.random.RandomState(3)
    p = {k: v.astype(jnp.bfloat16) for k, v in _ffn_params(rng).items()}
    x = rng.randn(64, 8).astype(jnp.bfloat16)
    jy = jax_expert.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), top_k=2)
    tp = {k: torch.tensor(np.asarray(v, np.float32)).bfloat16()
          for k, v in p.items()}
    tx = torch.tensor(np.asarray(x, np.float32)).bfloat16()
    y = expert.moe_ffn(tp, tx, top_k=2)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy, np.float32), rtol=1e-2,
                               atol=1e-2)
    y32 = expert.moe_ffn({k: v.float() for k, v in tp.items()}, tx.float(),
                         top_k=2)
    assert torch.equal(y32.bfloat16(), y)


def test_no_n_by_e_by_c_tensor_is_built():
    # The index dispatch: no tensor of the forward or the backward holds
    # N x E x C elements (the reference's dispatch and combine tensors).
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.most = max(Largest.most, t.numel())
            return out

    rng = np.random.RandomState(4)
    n, d, h, e = 512, 8, 16, 4
    p = {k: torch.tensor(v, requires_grad=True)
         for k, v in _ffn_params(rng, d, h, e).items()}
    x = torch.tensor(rng.randn(n, d).astype(np.float32), requires_grad=True)
    with Largest():
        y = expert.moe_ffn(p, x, top_k=2)
        y.square().sum().backward()
    c = expert.capacity(n, e, 1.25, 2)
    assert Largest.most < n * e * c
    assert Largest.most <= e * c * h  # the hidden activations


def test_mesh_is_refused_naming_a13():
    p = {k: torch.tensor(v) for k, v in _ffn_params(
        np.random.RandomState(5)).items()}
    with pytest.raises(NotImplementedError, match="A.13"):
        expert.moe_ffn(p, torch.zeros(4, 8), mesh=object())
    with pytest.raises(ValueError, match="top_k"):
        expert.moe_ffn(p, torch.zeros(4, 8), top_k=3)


def test_init_moe_params_is_he_normal():
    # Standard deviations sqrt(2 / d_model) (router, w1) and sqrt(2 /
    # d_hidden) (w2), the reference's; >= 2,048 draws each.
    d, h, e = 256, 1024, 8
    p = expert.init_moe_params(torch.Generator().manual_seed(0), d, h, e)
    j = jax_expert.init_moe_params(jax.random.PRNGKey(0), d, h, e)
    for k, a in j.items():
        assert tuple(p[k].shape) == a.shape
        if k.startswith("b"):
            assert not p[k].any()
            continue
        want = (2.0 / (h if k == "w2" else d)) ** 0.5
        np.testing.assert_allclose(float(p[k].std()), want, rtol=0.05)
        np.testing.assert_allclose(float(a.std()), want, rtol=0.05)


# ------------------------------------------------------------ the layer

def _moe_conf(m, **kw):
    return m.MoELayer(n_in=8, n_out=8, n_experts=4, expert_hidden=16,
                      **kw)


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_moe_layer_matches_the_reference(train, reference_draws):
    # The layer's key splits into dropout and jitter keys; leading dims
    # flatten into tokens; the activation; `_aux_loss` weighted.
    kw = dict(top_k=2, router_jitter=0.05, aux_loss_weight=0.3,
              activation="tanh", dropout=0.7)
    conf, jconf = _moe_conf(layers, **kw), _moe_conf(jax_layers, **kw)
    rng = np.random.RandomState(6)
    p = _ffn_params(rng)
    pp = {"gate_w": p["gate_w"], "w1": p["w1"], "b_1": p["b1"],
          "w2": p["w2"], "b_2": p["b2"]}
    x = rng.randn(3, 5, 8).astype(np.float32)
    sub = jax.random.PRNGKey(11)
    jrng = jax.random.fold_in(sub, 2) if train else None
    jy, jst, _ = jax_moe.moe_apply(jconf, {k: jnp.asarray(v)
                                           for k, v in pp.items()}, {},
                                   jnp.asarray(x), rng=jrng, train=train)
    y, st = moe.moe_apply(conf, interop.params_from_numpy({"l": pp})["l"],
                          {}, torch.tensor(x), train=train,
                          rng=prng.LayerKey(np.asarray(sub), 2)
                          if train else None)
    assert y.shape == (3, 5, 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(st["_aux_loss"]),
                               float(jst["_aux_loss"]), **F32)


def _mln_conf(m, updater="adam"):
    return (m.NeuralNetConfiguration.builder().seed(3).updater(updater)
            .learning_rate(0.05).list()
            .layer(m.DenseLayer(n_out=8, activation="relu"))
            .layer(m.MoELayer(n_out=8, n_experts=4, expert_hidden=16,
                              top_k=2, router_jitter=0.05,
                              aux_loss_weight=0.1))
            .layer(m.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(m.InputType.feed_forward(6)).build())


class _Ns:
    def __init__(self, layer_mod, nnc, input_type):
        self.__dict__.update({n: getattr(layer_mod, n) for n in (
            "DenseLayer", "MoELayer", "OutputLayer")})
        self.NeuralNetConfiguration = nnc
        self.InputType = input_type


PORT = _Ns(layers, NeuralNetConfiguration, InputType)
JAX = _Ns(jax_layers, JaxNNC, JaxInputType)


def test_moe_in_a_multilayer_network_trains_as_the_reference(
        reference_draws):
    # Three steps: the aux loss in the score, undivided by the batch, the
    # jitter from each step's key; then `score` and `output`.
    jnet = JaxMLN(_mln_conf(JAX)).init()
    pnet = MultiLayerNetwork(_mln_conf(PORT), device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    rng = np.random.RandomState(8)
    for _ in range(3):
        x = rng.randn(16, 6).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
        jnet.fit(JaxDataSet(x, y))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params",
                  STEP)
    np.testing.assert_allclose(pnet.updater_state_flat(),
                               np.asarray(jnet.updater_state_flat()), **STEP)
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               float(jnet.score(JaxDataSet(x, y))), **STEP)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                               **STEP)
    assert not pnet.state  # the aux loss is never kept as state


def test_moe_init_fans_are_per_expert():
    # w1 [E, in, H] and w2 [E, H, out] draw with the per-expert matmul's
    # fans (xavier: std sqrt(2 / (fan_in + fan_out))), as the reference's.
    # The router [256, 16] has 4,096 draws (a standard deviation's
    # sampling error ~1.1%: held at 4%), each expert table ~1.6 million
    # (held at 1%).
    def conf(m):
        return (m.NeuralNetConfiguration.builder().seed(5)
                .weight_init("xavier").list()
                .layer(m.MoELayer(n_out=256, n_experts=16, expert_hidden=384))
                .layer(m.OutputLayer(n_out=3))
                .set_input_type(m.InputType.feed_forward(256)).build())

    port = MultiLayerNetwork(conf(PORT), device="cpu").init()
    ref = JaxMLN(conf(JAX)).init()
    for k, fan, tol in (("w1", 256 + 384, 0.01), ("w2", 384 + 256, 0.01),
                        ("gate_w", 256 + 16, 0.04)):
        got = port.params_tree["layer_0"][k].detach().numpy()
        want = np.asarray(ref.params_tree["layer_0"][k])
        assert got.shape == want.shape
        np.testing.assert_allclose(got.std(), (2.0 / fan) ** 0.5, rtol=tol)
        np.testing.assert_allclose(want.std(), (2.0 / fan) ** 0.5, rtol=tol)
        assert abs(float(got.mean())) < 0.05 * got.std()


# ------------------------------------------------- transformer_lm(moe=True)

def _pool():
    rng = np.random.RandomState(0)
    pool = []
    for _ in range(2):
        ids = rng.randint(0, V, (B, T + 1))
        pool.append((ids[:, :-1, None].astype(np.float32),
                     ids[:, 1:].astype(np.int32)))
    return pool


def _lm(m, **kw):
    return m.transformer_lm(V, t=T, d_model=D, n_heads=HEADS, n_blocks=NB,
                            moe=True, n_experts=4, **kw)


def test_zoo_moe_lm_conf_is_the_references():
    import json

    assert json.loads(_lm(zoo).to_json()) == json.loads(
        _lm(jax_zoo).to_json())
    net = ComputationGraph(_lm(zoo), device="cpu").init()
    assert net.num_params() == sum(
        int(np.prod(s)) for v in _lm(jax_zoo).vertices.values()
        if hasattr(v, "layer") for s in v.layer.param_shapes().values())


def test_moe_lm_fit_output_and_cached_greedy_match_the_reference(
        reference_draws):
    # Three Adam steps (score, params, Adam m and v, the key), then
    # `output` on one batch, then greedy decode through the KV cache.
    jconf = _lm(jax_zoo)
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(
        ComputationGraphConfiguration.from_json(jconf.to_json()),
        device="cpu").init(params=interop.params_from_numpy(
            _np_tree(jnet.params_tree)))
    pool = _pool()
    for i in range(3):
        x, y = pool[i % 2]
        jnet.fit(JaxMDS(features=[x], labels=[y]))
        pnet.fit(MultiDataSet([x], [y]))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value,
                                   **STEP)
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params",
                  LM_PARAMS)
    jopt = _np_tree(jnet.opt_state)
    for f in ("m", "v"):
        _assert_trees({v: s[f] for v, s in pnet.opt_state.items()},
                      {v: s[f] for v, s in jopt.items() if f in s},
                      f"adam {f}", STEP)
    np.testing.assert_array_equal(pnet._train_rng, np.asarray(
        jnet._train_rng if jnet._clock is None else jnet._clock[1]))
    x = pool[0][0]
    np.testing.assert_allclose(pnet.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **STEP)

    dconf = _lm(jax_zoo, decode_cache_length=T)
    jdec = JaxGraph(dconf).init(params={
        v: {k: jnp.asarray(a) * (10.0 if v == "out" else 1.0)
            for k, a in p.items()}
        for v, p in _np_tree(jnet.params_tree).items()})
    pdec = ComputationGraph(_lm(zoo, decode_cache_length=T),
                            device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jdec.params_tree)))
    prompt = [3, 9, 27, 17]
    want = jax_zoo.generate_lm(jdec, prompt, 12, window=T, temperature=0.0,
                               use_cache=True)
    got = zoo.generate_lm(pdec, prompt, 12, window=T, temperature=0.0,
                          use_cache=True)
    assert got == [int(i) for i in want]
    # The cached decode equals the windowed one (no cache).
    assert got == zoo.generate_lm(pdec, prompt, 12, window=T,
                                  temperature=0.0)


def test_moe_lm_zip_round_trips_in_both_packages(tmp_path):
    pnet = ComputationGraph(_lm(zoo), device="cpu").init()
    x, y = _pool()[0]
    pnet.fit(MultiDataSet([x], [y]))
    path = str(tmp_path / "moe_lm.zip")
    model_serializer.save_model(pnet, path)
    back = model_serializer.load_model(path, device="cpu")
    np.testing.assert_array_equal(back.params(), pnet.params())
    np.testing.assert_array_equal(back.updater_state_flat(),
                                  pnet.updater_state_flat())
    assert back.iteration == pnet.iteration
    jnet = jax_serializer.load_model(path)
    np.testing.assert_array_equal(np.asarray(jnet.params()), pnet.params())
    jpath = str(tmp_path / "moe_lm_ref.zip")
    jax_serializer.save_model(jnet, jpath)
    again = model_serializer.load_model(jpath, device="cpu")
    np.testing.assert_array_equal(again.params(), pnet.params())
    np.testing.assert_allclose(again.output(x)[0], pnet.output(x)[0],
                               rtol=1e-6, atol=1e-7)
