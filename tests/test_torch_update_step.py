"""The training step's update entry, `fused_update.apply_step`, and the
engine that drives it (`nn/engine.py` `_apply_updates`), on the CPU.

- `apply_step` on CPU tensors against the per-layer path it replaced:
  `dispatch`, the bias-rate factor, then `sub_` (or `add_` when
  maximizing), for adam, nesterovs and rmsprop, over two layers at
  different learning rates, one with factors: equal bit for bit, one plain
  call per layer.
- The engine with layers of several updaters (two fused kinds, sgd beside
  them), per-layer learning rates under a schedule, `bias_learning_rate`
  and `minimize=False`: one `apply_step` per (kind, hyper) group, equal bit
  for bit to the per-layer loop it replaced, and over 3 steps of a small
  `ComputationGraph` and 3 truncated-BPTT fit calls of a small
  `MultiLayerNetwork` equal to the JAX package's steps at the training
  slices' tolerances (rtol 2e-4; the RNN's params atol 1e-4, as
  `tests/test_torch_rnn_slice.py` explains for RMSProp).
- `kernels.Count` from several threads, the LayerNorm wrapper's device
  and activation handling.

Inputs come from numpy RandomStates (and the JAX nets' seeded params).
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JaxMDS
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.kernels import fused_update, norm_act
from deeplearning4j_tpu_torch.nn.conf.layers import is_bias_param
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import grad_norm

F32 = dict(rtol=2e-4, atol=2e-5)
RNN_PARAMS = dict(rtol=2e-4, atol=1e-4)
HYPER = {"adam": (0.9, 0.999, 1e-8), "nesterovs": (0.9,),
         "rmsprop": (0.95, 1e-8)}
SHAPES = {"W": (33, 7), "b": (5,), "gamma": (1025,)}


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package (see
    `tests/test_torch_rnn_slice.py`: a deserialised executable of a second
    net of one configuration refuses its arguments on the 8-device CPU
    mesh); the session's root is put back after each test."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def _layer(rng, kind):
    def tree(scale, positive=False):
        out = {}
        for k, s in SHAPES.items():
            a = rng.randn(*s) * scale
            out[k] = torch.tensor(np.abs(a) if positive else a,
                                  dtype=torch.float32)
        return out

    params, grads = tree(1.0), tree(1.0)
    if kind == "adam":
        state = {"m": tree(0.1), "v": tree(0.01, positive=True)}
    elif kind == "nesterovs":
        state = {"v": tree(0.1)}
    else:
        state = {"g2": tree(0.01, positive=True)}
    return params, state, grads


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _to(tree, device):
    if isinstance(tree, (dict, tuple)):
        return ({k: _to(v, device) for k, v in tree.items()}
                if isinstance(tree, dict)
                else tuple(_to(v, device) for v in tree))
    return tree.to(device)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("kind", fused_update.KINDS)
def test_apply_step_on_cpu_equals_dispatch_factor_sub(kind, sign):
    rng = np.random.RandomState(len(kind))
    layers = [_layer(rng, kind) for _ in range(2)]
    lrs, step = (3e-3, 7e-4), 4
    factors = [None, {"b": 2.5, "gamma": 0.5}]
    # The per-layer path the engine ran before apply_step existed.
    want_params, want_states = [], []
    for (params, state, grads), lr, fac in zip(layers, lrs, factors):
        params = _clone(params)
        st, deltas = fused_update.dispatch(kind, _clone(state), grads, lr,
                                           step, HYPER[kind])
        if fac:
            deltas = {k: d * fac[k] if k in fac else d
                      for k, d in deltas.items()}
        for k, p in params.items():
            p.sub_(deltas[k]) if sign > 0 else p.add_(deltas[k])
        want_params.append(params)
        want_states.append(st)
    items = [fused_update.UpdateItem(_clone(p), _clone(s), g, lr, fac)
             for (p, s, g), lr, fac in zip(layers, lrs, factors)]
    kernels.reset_counts()
    got_states = fused_update.apply_step(kind, HYPER[kind], items, step,
                                         sign)
    c = kernels.counts()
    assert c["plain_calls"]["fused_update"] == 2  # one per layer
    assert not any(c["launches"].values())
    for item, got_st, want_p, want_st in zip(items, got_states, want_params,
                                             want_states):
        for k in SHAPES:
            assert torch.equal(item.params[k], want_p[k]), k
            for f in fused_update.FIELDS[kind]:
                assert torch.equal(got_st[f][k], want_st[f][k]), (f, k)


def test_apply_step_refuses_an_unknown_kind_and_passes_no_grads_through():
    with pytest.raises(ValueError, match="no 'adamax' body"):
        fused_update.apply_step("adamax", (), [], 0, 1.0)
    st = {"g2": {"W": torch.zeros(2)}}
    item = fused_update.UpdateItem({"W": torch.ones(2)}, st, {}, 0.1)
    kernels.reset_counts()
    assert fused_update.apply_step("rmsprop", HYPER["rmsprop"], [item], 0,
                                   1.0) == [st]
    assert not any(kernels.counts()["plain_calls"].values())


@pytest.mark.parametrize("kind", fused_update.KINDS)
def test_apply_step_refuses_mixed_devices_whichever_item_comes_first(kind):
    # The first item on the CPU picks the plain path; a later item on
    # another device (here "meta", which the plain bodies would run) must
    # raise before any plain call, as `dispatch` raises for one layer.
    rng = np.random.RandomState(21)
    cpu = _layer(rng, kind)
    other = _to(_layer(rng, kind), "meta")
    for first, second in ((cpu, other), (other, cpu)):
        items = [fused_update.UpdateItem(p, s, g, 1e-3)
                 for p, s, g in (first, second)]
        kernels.reset_counts()
        with pytest.raises(ValueError, match="devices|cpu"):
            fused_update.apply_step(kind, HYPER[kind], items, 0, 1.0)
        c = kernels.counts()
        assert not any(c["plain_calls"].values())
        assert not any(c["launches"].values())
    # One item whose state alone lies elsewhere raises too.
    p, s, g = _layer(rng, kind)
    f0 = fused_update.FIELDS[kind][0]
    s[f0]["W"] = s[f0]["W"].to("meta")
    with pytest.raises(ValueError, match="devices"):
        fused_update.apply_step(kind, HYPER[kind], [
            fused_update.UpdateItem(p, s, g, 1e-3)], 0, 1.0)
    assert not kernels.counts()["plain_calls"]["fused_update"]


def _packed(kind, layers):
    """`apply_step`'s table over `layers` (CPU tensors stand in for one
    card's: `_pack` and `_regrad` check and pack, and launch nothing)."""
    f0 = fused_update.FIELDS[kind][0]
    entries = [(p[k], g, s[f0][k], s["v"][k] if kind == "adam" else None,
                1e-3, 1.0, k)
               for p, s, g in layers for k, g in g.items()]
    return fused_update._pack(fused_update._SUB, entries)


@pytest.mark.parametrize("kind", fused_update.KINDS)
def test_step_table_is_reused_while_params_and_state_stay(kind):
    # A step after the first renews only the grads, lrs and factors of the
    # packed table; a param or state replaced, moved to new storage, or a
    # layer more or less makes the table be packed anew.
    rng = np.random.RandomState(22)
    layers = [_layer(rng, kind) for _ in range(2)]
    table = _packed(kind, layers)
    n = len(layers) * len(SHAPES)
    assert len(table.numels) == n and len(table.kept) == n * (
        3 if kind == "adam" else 2)
    grads = [{k: torch.tensor(rng.randn(*s), dtype=torch.float32)
              for k, s in SHAPES.items()} for _ in layers]
    items = [fused_update.UpdateItem(p, st, g, lr, fac) for (p, st, _), g,
             lr, fac in zip(layers, grads, (2e-3, 5e-4), (None, {"b": 2.0}))]
    assert fused_update._regrad(table, kind, items)
    assert table.gs == [g[k].data_ptr() for g in grads for k in SHAPES]
    assert table.lrs == [2e-3] * 3 + [5e-4] * 3
    assert table.facs == [1.0] * 4 + [2.0, 1.0]
    assert table.outs == [p[k].data_ptr() for p, _, _ in layers
                          for k in SHAPES]
    # A grad the kernel cannot take is refused on the reused table too.
    bad = dict(grads[0], b=grads[0]["b"].double())
    with pytest.raises(TypeError, match="float32"):
        fused_update._regrad(table, kind, [items[0]._replace(grads=bad),
                                           items[1]])
    bad = dict(grads[0], gamma=torch.zeros(2050)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        fused_update._regrad(table, kind, [items[0]._replace(grads=bad),
                                           items[1]])
    f0 = fused_update.FIELDS[kind][0]
    swaps = [
        lambda p, s: p.__setitem__("W", p["W"].clone()),  # a new tensor
        lambda p, s: p["b"].set_(torch.zeros(5)),        # new storage
        lambda p, s: s[f0].__setitem__("gamma", s[f0]["gamma"].clone()),
    ]
    for swap in swaps:
        p, s = _clone(layers[0][0]), _clone(layers[0][1])
        table = _packed(kind, [(p, s, grads[0])])
        item = fused_update.UpdateItem(p, s, grads[0], 1e-3)
        assert fused_update._regrad(table, kind, [item])
        swap(p, s)
        assert not fused_update._regrad(table, kind, [item])
    table = _packed(kind, layers)
    assert not fused_update._regrad(table, kind, items[:1])
    assert not fused_update._regrad(table, kind, items + items[:1])
    assert not fused_update._regrad(table, kind, items[::-1])


def test_engine_empties_its_update_tables_where_params_are_replaced():
    _, conf = _graph_confs()
    net = ComputationGraph(conf, device="cpu").init()
    net._update_tables["x"] = object()
    net.init()
    assert net._update_tables == {}
    net._update_tables["x"] = object()
    net.set_updater_state({"opt_state": net.opt_state, "iteration": 0})
    assert net._update_tables == {}


# ---------------------------------------------------------------- engine

def _set_layer(layer, updater=None, lr=None, bias_lr=None):
    if updater is not None:
        layer.updater = type(layer.updater)(updater)
    if lr is not None:
        layer.learning_rate = lr
    if bias_lr is not None:
        layer.bias_learning_rate = bias_lr


def _graph_confs():
    """A small LM whose layers mix updaters (Adam, Nesterovs, RMSProp,
    sgd), learning rates and bias rates under an exponential schedule,
    maximizing: the JAX conf and the port's from its JSON."""
    jconf = jax_zoo.transformer_lm(64, t=32, d_model=32, n_heads=4,
                                   n_blocks=1)
    v = jconf.vertices
    _set_layer(v["emb"].layer, lr=0.01)
    _set_layer(v["attn0"].layer, bias_lr=0.009)          # factor 3
    _set_layer(v["ff1_0"].layer, "nesterovs", 0.02, 0.01)
    _set_layer(v["ffn0"].layer, "nesterovs", 0.02)
    _set_layer(v["ln_f0"].layer, "sgd", 0.05)
    _set_layer(v["out"].layer, "rmsprop", 0.004, 0.002)
    g = jconf.global_conf
    g.minimize = False
    g.lr_policy, g.lr_policy_decay_rate = "exponential", 0.9
    return jconf, ComputationGraphConfiguration.from_json(jconf.to_json())


def _rnn_confs():
    """The small char-RNN with a layer each of Adam (with a bias rate),
    sgd and RMSProp at its own rate, maximizing, under an exponential
    schedule."""
    jconf = jax_zoo.char_rnn(vocab_size=11, hidden=8, tbptt_length=5)
    _set_layer(jconf.layers[0], "adam", 0.01, 0.03)
    _set_layer(jconf.layers[1], "sgd", 0.05)
    _set_layer(jconf.layers[2], None, 0.02, 0.01)
    g = jconf.global_conf
    g.minimize = False
    g.lr_policy, g.lr_policy_decay_rate = "exponential", 0.9
    return jconf, MultiLayerConfiguration.from_json(jconf.to_json())


def _np(tree):
    # np.array copies: the JAX step donates its buffers. A stateless
    # updater's state is () in JAX.
    return {k: ({} if not p else
                {f: {n: np.array(a) for n, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values())), dict)
                else {n: np.array(a) for n, a in p.items()})
            for k, p in tree.items()}


def _per_layer_update(net, grads):
    """The engine's update loop before `apply_step`: per layer, normalize,
    schedule, the updater's deltas, the bias-rate factor, then
    params -= sign * deltas."""
    g = net._global
    sign = 1.0 if g.minimize else -1.0
    step = net.iteration
    with torch.no_grad():
        for name, layer in net._layer_confs.items():
            lgrads = grads.get(name)
            if not lgrads:
                continue
            lgrads = grad_norm.normalize_layer_gradients(
                lgrads, layer.gradient_normalization,
                float(layer.gradient_normalization_threshold or 1.0))
            lr = net._schedules[name](step)
            st, deltas = net._updaters[name].update(net.opt_state[name],
                                                    lgrads, lr, step)
            base_lr = float(layer.learning_rate
                            if layer.learning_rate is not None
                            else g.learning_rate)
            bias_lr = float(layer.bias_learning_rate
                            if layer.bias_learning_rate is not None
                            else base_lr)
            if bias_lr != base_lr and base_lr != 0.0:
                factor = bias_lr / base_lr
                deltas = {k: (d * factor if is_bias_param(k) else d)
                          for k, d in deltas.items()}
            for k, p in net.params_tree[name].items():
                if k in deltas:
                    p.sub_(deltas[k]) if sign > 0 else p.add_(deltas[k])
            net.opt_state[name] = st


def test_engine_groups_fused_layers_and_equals_the_per_layer_loop(
        monkeypatch):
    _, conf = _graph_confs()
    nets = [ComputationGraph(conf, device="cpu").init() for _ in range(2)]
    rng = np.random.RandomState(3)
    calls = []
    real = fused_update.apply_step

    def spy(kind, hyper, items, step, sign, tables):
        assert tables is nets[0]._update_tables
        calls.append((kind, len(items), step, sign))
        return real(kind, hyper, items, step, sign, tables)

    monkeypatch.setattr(fused_update, "apply_step", spy)
    for step in range(3):
        grads = {v: {k: torch.tensor(rng.randn(*p.shape), dtype=p.dtype)
                     for k, p in ps.items()}
                 for v, ps in nets[0].params_tree.items()}
        kernels.reset_counts()
        nets[0]._train_update(grads)
        # emb, pos, ln_a0, attn0, ln_out: Adam; ff1_0, ffn0: Nesterovs;
        # out: RMSProp; ln_f0: sgd, updated in the loop.
        assert calls == [("adam", 5, step, -1.0), ("nesterovs", 2, step, -1.0),
                         ("rmsprop", 1, step, -1.0)]
        assert kernels.counts()["plain_calls"]["fused_update"] == 8
        calls.clear()
        _per_layer_update(nets[1], grads)
        for net in nets:
            net.iteration += 1
    for v, ps in nets[1].params_tree.items():
        for k, p in ps.items():
            assert torch.equal(nets[0].params_tree[v][k], p), (v, k)
        for f, s in nets[1].opt_state[v].items():
            for k, a in s.items():
                assert torch.equal(nets[0].opt_state[v][f][k], a), (v, f, k)


def test_mixed_updater_graph_matches_jax_over_three_steps():
    jconf, conf = _graph_confs()
    jnet = JaxGraph(jconf).init()
    pnet = ComputationGraph(conf, device="cpu").init(
        params=interop.params_from_numpy(_np(jnet.params_tree)))
    rng = np.random.RandomState(0)
    for _ in range(3):
        ids = rng.randint(0, 64, (2, 33))
        x, y = ids[:, :-1, None].astype(np.float32), ids[:, 1:].astype(
            np.int32)
        jnet.fit(JaxMDS([x], [y]))
        pnet.fit(MultiDataSet([x], [y]))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value, **F32)
    for v, ps in _np(jnet.params_tree).items():
        for k, a in ps.items():
            np.testing.assert_allclose(pnet.params_tree[v][k].detach().numpy(),
                                       a, err_msg=f"{v}/{k}", **F32)
    jopt = _np(jnet.opt_state)
    for v, st in jopt.items():
        for f, s in st.items():
            for k, a in s.items():
                np.testing.assert_allclose(
                    pnet.opt_state[v][f][k].numpy(), a,
                    err_msg=f"{v}/{f}/{k}", **F32)


def test_mixed_updater_rnn_matches_jax_over_three_tbptt_calls():
    jconf, conf = _rnn_confs()
    jnet = JaxMLN(jconf).init()
    pnet = MultiLayerNetwork(conf, device="cpu").init(
        params=interop.params_from_numpy(_np(jnet.params_tree)))
    eye = np.eye(11, dtype=np.float32)
    rng = np.random.RandomState(9)
    kernels.reset_counts()
    for _ in range(3):
        ids = rng.randint(0, 11, (3, 13))
        x, y = eye[ids[:, :-1]], eye[ids[:, 1:]]
        jnet.fit(JaxDataSet(jnp.asarray(x), jnp.asarray(y)))
        pnet.fit(DataSet(x, y))
        np.testing.assert_allclose(pnet.score_value, jnet.score_value, **F32)
    # 3 chunks (5, 5, 2) per call: the Adam and RMSProp layers one plain
    # call each per chunk; the step advances once per sequence.
    assert kernels.counts()["plain_calls"]["fused_update"] == 3 * 3 * 2
    assert pnet.iteration == jnet.iteration == 3
    for k, ps in _np(jnet.params_tree).items():
        for n, a in ps.items():
            np.testing.assert_allclose(pnet.params_tree[k][n].detach().numpy(),
                                       a, err_msg=f"{k}/{n}", **RNN_PARAMS)
    jopt = _np(jnet.opt_state)
    for k in ("layer_0", "layer_2"):
        for f, s in jopt[k].items():
            for n, a in s.items():
                np.testing.assert_allclose(
                    pnet.opt_state[k][f][n].numpy(), a,
                    err_msg=f"{k}/{f}/{n}", **F32)


# ---------------------------------------------------- counts, LayerNorm

def test_count_adds_from_several_threads_are_never_lost():
    # Two readers read while 8 threads add: a read neither adds nor loses
    # a count, and each reader sees the count only grow.
    c = kernels.Count()
    n, workers = 20000, 8
    seen = [[], []]

    def read(out):
        for _ in range(2000):
            out.append(c.value)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [c.add()
                                                    for _ in range(n)])
                   for _ in range(workers)]
        threads += [threading.Thread(target=read, args=(s,)) for s in seen]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value == n * workers
    assert c.value == n * workers
    for s in seen:
        assert len(s) == 2000 and s == sorted(s) and s[-1] <= n * workers
    c.reset()
    assert c.value == 0
    c.add()
    assert c.value == 1


def test_layernorm_wrapper_devices_and_activation_codes():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="on meta"):
        norm_act._layernorm_forward(x.to("meta"), x[0].to("meta"),
                                    x[0].to("meta"), 1e-5, "identity")
    with pytest.raises(ValueError, match="different devices"):
        norm_act._layernorm_forward(x, x[0].to("meta"), x[0], 1e-5, None)
    kernels.reset_counts()
    y = norm_act._layernorm_forward(x + 1, x[0] + 1, x[0], 1e-5, "RELU")
    assert kernels.counts()["plain_calls"]["layernorm_norm_act"] == 1
    assert torch.equal(y, torch.zeros(2, 8))
    for act, code in (("identity", 0), (None, 0), ("Relu", 1), ("tanh", 2),
                      ("SIGMOID", 3)):
        assert norm_act._act_code(act) == code
        assert norm_act._act_code(act) == code  # cached
    with pytest.raises(ValueError, match="not in the kernel's set"):
        norm_act._act_code("gelu")
