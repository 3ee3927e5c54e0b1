"""The port's char-RNN slice as a whole against the JAX package, on the CPU:
the recurrent layer confs and layers, `MultiLayerConfiguration`,
`MultiLayerNetwork` (`output`, `feed_forward`, `score`, `rnn_time_step`,
`fit` standard and under truncated BPTT, the flat param view) and
`models/zoo.py` `char_rnn`.

Small sizes: V=11, hidden 8 or 12, 2 GravesLSTM layers, B=3, T=12 in tBPTT
chunks of 5 (two full chunks and a 2-step remainder). Params (and, for the
resume case, the RMSProp state) are copied across from the JAX package's
net as numpy; inputs are one-hot sequences from a seeded numpy generator.

Tolerances: layer forwards, `output`, `rnn_time_step` rtol = atol = 1e-5
(the same ops, sums in another order). Training, f32: each call's score
and RMSProp's g2 after it rtol 2e-4, atol 2e-5, as the training tests of
the earlier slices; the params rtol 2e-4, atol 1e-4. RMSProp's step
lr * g / sqrt(g2 + eps) is flat in g where |g| is large and steep where
|g| is near sqrt(eps / (1 - decay)) ~ 4.5e-4: there it moves a param by
about lr / sqrt(eps) = 1000 times its gradient's absolute rounding error
(~1e-8), some 1e-5 per step, over up to nine steps. The g2 and the scores
hold the gradients themselves to the tighter tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import compilation
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models import zoo as jax_zoo
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.layers import recurrent as jax_recurrent
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import prng
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    GlobalConf,
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import common, recurrent
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

FWD = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=2e-4, atol=2e-5)
PARAMS = dict(rtol=2e-4, atol=1e-4)
V, B, T, CHUNK = 11, 3, 12, 5


@pytest.fixture(autouse=True)
def fresh_compile_cache(tmp_path, monkeypatch):
    """A compile-cache root of each test's own for the JAX package, as
    `tests/test_compile_cache.py` gives its tests: a second JAX net of the
    same configuration in one process would otherwise take the first's
    executable from the AOT store, and a deserialised executable refuses
    its arguments on the 8-device CPU mesh. The session's root is put back
    after each test."""
    monkeypatch.setenv(compilation.ENV_KNOB, str(tmp_path / "compile-cache"))
    compilation.reset()
    yield
    monkeypatch.undo()
    compilation.reset()
    compilation.configure_persistent_cache()


def _np_tree(tree):
    # np.array copies: the JAX step donates its buffers.
    return {k: ({f: {n: np.array(a) for n, a in s.items()}
                 for f, s in p.items()}
                if isinstance(next(iter(p.values()), None), dict)
                else {n: np.array(a) for n, a in p.items()})
            for k, p in tree.items()}


def _onehot(ids):
    return np.eye(V, dtype=np.float32)[ids]


def _batch(seed, t=T, b=B):
    ids = np.random.RandomState(seed).randint(0, V, (b, t + 1))
    return _onehot(ids[:, :-1]), _onehot(ids[:, 1:])


def _nets(hidden=8, backprop_type="truncatedbptt"):
    jconf = jax_zoo.char_rnn(vocab_size=V, hidden=hidden,
                             tbptt_length=CHUNK)
    pconf = zoo.char_rnn(vocab_size=V, hidden=hidden, tbptt_length=CHUNK)
    jconf.backprop_type = backprop_type
    pconf.backprop_type = backprop_type
    jnet = JaxMLN(jconf).init()
    pnet = MultiLayerNetwork(pconf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)))
    return jnet, pnet


def _assert_trees(port_tree, jax_tree, what, tol=F32):
    for k, p in jax_tree.items():
        for n, a in p.items():
            got = port_tree[k][n]
            np.testing.assert_allclose(got.detach().numpy(), a,
                                       err_msg=f"{what} {k}/{n}", **tol)


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("hidden", [200, 256])
def test_char_rnn_matches_the_reference_json(hidden):
    ref = MultiLayerConfiguration.from_json(
        jax_zoo.char_rnn(vocab_size=77, hidden=hidden).to_json())
    got = zoo.char_rnn(vocab_size=77, hidden=hidden)
    assert got == ref
    assert [type(x).__name__ for x in got.layers] == [
        "GravesLSTM", "GravesLSTM", "RnnOutputLayer"]
    assert [(x.n_in, x.n_out) for x in got.layers] == [
        (77, hidden), (hidden, hidden), (hidden, 77)]
    assert (got.backprop_type, got.tbptt_fwd_length,
            got.tbptt_back_length) == ("truncatedbptt", 50, 50)
    assert dataclasses.asdict(got.global_conf)["updater"] == "rmsprop"
    assert got.layers[0].l2 == 0.001 and got.layers[0].learning_rate == 0.1


@pytest.mark.parametrize("cls", ["GravesLSTM", "LSTM",
                                 "GravesBidirectionalLSTM", "SimpleRnn"])
def test_recurrent_confs_match_the_reference(cls):
    jl = getattr(jax_layers, cls)(n_in=5, n_out=7, activation="tanh")
    got = layers.layer_from_dict(jl.to_dict())
    assert type(got).__name__ == cls
    assert got.param_shapes() == jl.param_shapes()
    assert got.weight_param_keys() == list(jl.weight_param_keys())
    assert got.get_output_type(InputType.recurrent(5, 9)) == \
        InputType.recurrent(7, 9)


def test_preprocessors_and_cnn_inputs_are_refused():
    # Refused until the LeNet slice; now read and inserted as the
    # reference does (tests/test_torch_lenet_slice.py holds them to it).
    lenet = MultiLayerConfiguration.from_json(jax_zoo.lenet_mnist().to_json())
    assert sorted(lenet.input_preprocessors) == [4]
    assert lenet.input_type == InputType.convolutional(28, 28, 1)
    conf = MultiLayerConfiguration.build(
        GlobalConf(), [layers.GravesLSTM(n_out=4)], InputType.feed_forward(3))
    assert type(conf.input_preprocessors[0]).__name__ == \
        "FeedForwardToRnnPreProcessor"
    assert conf.layers[0].n_in == 3
    with pytest.raises(ValueError, match="unknown input type"):
        InputType.from_dict({"kind": "cnn3d"})
    conf = MultiLayerConfiguration.build(
        GlobalConf(l2=0.5), [layers.DenseLayer(n_out=4),
                             layers.OutputLayer(n_out=2)],
        InputType.feed_forward(3))
    assert [(x.n_in, x.n_out, x.l2) for x in conf.layers] == [
        (3, 4, 0.5), (4, 2, 0.5)]


# -------------------------------------------------------------- layers


def _layer_case(cls, masked, seed=0):
    rng = np.random.RandomState(seed)
    jl = getattr(jax_layers, cls)(n_in=5, n_out=7, activation="tanh",
                                  gate_activation="sigmoid") \
        if cls != "SimpleRnn" else jax_layers.SimpleRnn(
            n_in=5, n_out=7, activation="tanh")
    params = {k: (rng.randn(*s) * 0.4).astype(np.float32)
              for k, s in jl.param_shapes().items()}
    x = rng.randn(2, 6, 5).astype(np.float32)
    mask = (np.array([[1, 1, 1, 0, 1, 0], [1, 1, 1, 1, 1, 1]], np.float32)
            if masked else None)
    return jl, params, x, mask


_APPLY = {"GravesLSTM": "graves_lstm_apply", "LSTM": "standard_lstm_apply",
          "GravesBidirectionalLSTM": "bidirectional_lstm_apply",
          "SimpleRnn": "simple_rnn_apply"}  # the same name in both packages


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cls", sorted(_APPLY))
def test_recurrent_layer_forward_matches_jax(cls, masked):
    jl, params, x, mask = _layer_case(cls, masked)
    jfn, pfn = (getattr(m, _APPLY[cls]) for m in (jax_recurrent, recurrent))
    want, jstate, _ = jfn(jl, {k: jnp.asarray(a) for k, a in params.items()},
                          {}, jnp.asarray(x),
                          mask=None if mask is None else jnp.asarray(mask))
    pl = layers.layer_from_dict(jl.to_dict())
    got, pstate = pfn(pl, {k: torch.tensor(a) for k, a in params.items()},
                      {}, torch.tensor(x), mask=None if mask is None
                      else torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    for k, a in (jstate or {}).items():
        np.testing.assert_allclose(pstate[k].numpy(), np.asarray(a), **FWD)


def test_lstm_layer_state_seeds_the_scan():
    jl, params, x, _ = _layer_case("GravesLSTM", False, seed=5)
    pl = layers.layer_from_dict(jl.to_dict())
    tp = {k: torch.tensor(a) for k, a in params.items()}
    full, _ = recurrent.graves_lstm_apply(pl, tp, {}, torch.tensor(x))
    first, st = recurrent.graves_lstm_apply(pl, tp, {}, torch.tensor(x[:, :2]))
    rest, _ = recurrent.graves_lstm_apply(pl, tp, st, torch.tensor(x[:, 2:]))
    np.testing.assert_allclose(torch.cat([first, rest], 1).numpy(),
                               full.numpy(), **FWD)


# ------------------------------------------------------------ network


@pytest.mark.parametrize("hidden", [8, 12])
def test_output_feed_forward_and_score_match_jax(hidden):
    jnet, pnet = _nets(hidden)
    x, y = _batch(1)
    kernels.reset_counts()
    got = pnet.output(x)
    assert kernels.counts()["plain_calls"]["lstm_cell"] == 2 * T
    np.testing.assert_allclose(got, jnet.output(x), **FWD)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    for g, w in zip(pnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(g, w, **FWD)
    assert np.array_equal(pnet.predict(x), got.argmax(-1))
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=1e-5)
    lmask = np.ones((B, T), np.float32)
    lmask[0, 7:] = 0
    np.testing.assert_allclose(pnet.score(DataSet(x, y, None, lmask)),
                               jnet.score(JaxDataSet(x, y, None, lmask)),
                               rtol=1e-5)


def test_rnn_time_step_matches_jax_and_the_full_output():
    jnet, pnet = _nets(12)
    x, _ = _batch(2)
    full = pnet.output(x)
    # One step, then three, then single steps to the end: h and c carry.
    pieces = [x[:, 0], x[:, 1:4]] + [x[:, t] for t in range(4, T)]
    got, want = [], []
    for piece in pieces:
        got.append(pnet.rnn_time_step(piece))
        want.append(jnet.rnn_time_step(piece))
        np.testing.assert_allclose(got[-1], want[-1], **FWD)
    stacked = np.concatenate([g if g.ndim == 3 else g[:, None] for g in got],
                             1)
    np.testing.assert_allclose(stacked, full, **FWD)
    pnet.rnn_clear_previous_state()
    np.testing.assert_allclose(pnet.rnn_time_step(x[:, 0]), full[:, 0], **FWD)
    kernels.reset_counts()
    pnet.rnn_time_step(x[:, 1])
    assert kernels.counts()["plain_calls"]["lstm_cell"] == 2


@pytest.fixture(scope="module")
def fit_run():
    """Three tBPTT fit calls on the same nets (T=12: chunks 5, 5, 2), then
    two standard-backprop calls on a second pair, each call's score and the
    params and g2 after it recorded on both sides."""
    out = {}
    for bp, calls in (("truncatedbptt", 3), ("standard", 2)):
        jnet, pnet = _nets(8, bp)
        rec = []
        kernels.reset_counts()
        for i in range(calls):
            x, y = _batch(10 + i)
            jnet.fit(JaxDataSet(x, y))
            pnet.fit(DataSet(x, y))
            rec.append((jnet.score_value, pnet.score_value,
                        _np_tree(jnet.params_tree),
                        _np_tree(jnet.opt_state),
                        {k: {n: a.detach().clone() for n, a in p.items()}
                         for k, p in pnet.params_tree.items()},
                        {k: {n: a.clone() for n, a in s["g2"].items()}
                         for k, s in pnet.opt_state.items()}))
        out[bp] = dict(jnet=jnet, pnet=pnet, rec=rec,
                       counts=kernels.counts())
    return out


@pytest.mark.parametrize("bp", ["truncatedbptt", "standard"])
def test_fit_matches_jax_call_by_call(fit_run, bp):
    r = fit_run[bp]
    for i, (js, ps, jp, jopt, pp, pg2) in enumerate(r["rec"]):
        np.testing.assert_allclose(ps, js, err_msg=f"score {i}", **F32)
        _assert_trees(pg2, {k: s["g2"] for k, s in jopt.items()},
                      f"g2 after call {i}")
        _assert_trees(pp, jp, f"params after call {i}", PARAMS)
    assert r["pnet"].iteration == r["jnet"].iteration == len(r["rec"])
    # Carried h and c never outlive a sequence.
    assert r["pnet"].state == {}


def test_fit_launch_counts_and_steps(fit_run):
    # Per call: one cell per layer and time step (2 x 12); one update per
    # layer per chunk (3 x 3 under tBPTT, 3 x 1 standard).
    assert fit_run["truncatedbptt"]["counts"]["plain_calls"]["lstm_cell"] \
        == 3 * 2 * T
    assert fit_run["truncatedbptt"]["counts"]["plain_calls"][
        "fused_update"] == 3 * 3 * 3
    assert fit_run["standard"]["counts"]["plain_calls"]["fused_update"] \
        == 2 * 3
    assert not any(fit_run["truncatedbptt"]["counts"]["launches"].values())


def test_tbptt_truncates_the_gradient_at_the_chunk_edge():
    # The second chunk's gradient with the carried h and c detached equals
    # one computed from the same carried values given as constants.
    _, pnet = _nets(8)
    x, y = _batch(3)
    first = DataSet(x[:, :CHUNK], y[:, :CHUNK])
    pnet.conf.backprop_type = "standard"
    pnet.fit(first)  # one step; no carry under standard backprop
    assert pnet.state == {}
    pnet.conf.backprop_type = "truncatedbptt"
    before = {k: {n: a.detach().clone() for n, a in p.items()}
              for k, p in pnet.params_tree.items()}
    pnet.fit(DataSet(x, y))
    moved = max(float((pnet.params_tree[k][n] - a).abs().max())
                for k, p in before.items() for n, a in p.items())
    assert moved > 0 and np.isfinite(pnet.score_value)


def test_masked_tbptt_fit_matches_jax():
    # A row masked out of the last chunk still counts in every chunk's
    # divisor (the whole sequence's rows).
    jnet, pnet = _nets(8)
    x, y = _batch(4)
    fmask = np.ones((B, T), np.float32)
    fmask[1, 9:] = 0
    lmask = fmask.copy()
    jnet.fit(JaxDataSet(x, y, fmask, lmask))
    pnet.fit(DataSet(x, y, fmask, lmask))
    np.testing.assert_allclose(pnet.score_value, jnet.score_value, **F32)
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params",
                  PARAMS)


def test_resume_from_the_reference_updater_state():
    # interop carries the RMSProp state and the iteration across.
    jnet, pnet = _nets(8)
    x, y = _batch(5)
    jnet.fit(JaxDataSet(x, y))
    resumed = MultiLayerNetwork(pnet.conf, device="cpu").init(
        params=interop.params_from_numpy(_np_tree(jnet.params_tree)),
        updater_state=interop.updater_state_from_numpy(
            _np_tree(jnet.opt_state), jnet.iteration))
    assert resumed.iteration == 1
    x, y = _batch(6)
    jnet.fit(JaxDataSet(x, y))
    resumed.fit(DataSet(x, y))
    np.testing.assert_allclose(resumed.score_value, jnet.score_value, **F32)
    _assert_trees(resumed.params_tree, _np_tree(jnet.params_tree), "params",
                  PARAMS)


def test_flat_params_view_matches_jax():
    jnet, pnet = _nets(8)
    flat = pnet.params()
    np.testing.assert_array_equal(flat, np.asarray(jnet.params()))
    assert pnet.num_params() == jnet.num_params() == flat.size
    pnet.set_params(flat * 2)
    np.testing.assert_array_equal(pnet.params(), flat * 2)
    x, _ = _batch(7)
    jnet.set_params(flat * 2)
    np.testing.assert_allclose(pnet.output(x), jnet.output(x), **FWD)
    with pytest.raises(ValueError, match="flat param length"):
        pnet.set_params(flat[:-1])


def test_lstm_init_statistics():
    gen = torch.Generator().manual_seed(0)
    n_in, n = 300, 200
    p = params_mod.init_layer_params(layers.GravesLSTM(
        n_in=n_in, n_out=n, weight_init="xavier", bias_init=0.0,
        forget_gate_bias_init=1.0), gen)
    assert list(p) == ["W", "RW", "pW", "b"]
    assert torch.equal(p["b"][n:2 * n], torch.ones(n))
    assert not p["b"][:n].any() and not p["b"][2 * n:].any()
    assert torch.equal(p["pW"], torch.zeros(3 * n))
    # Xavier from n_in / n_out, not the packed 4n: N(0, sqrt(2/(fi+fo))).
    for k, fan_in in (("W", n_in), ("RW", n)):
        want = (2.0 / (fan_in + n)) ** 0.5
        assert abs(float(p[k].std()) / want - 1) < 0.02, k
        assert abs(float(p[k].mean())) < 0.02 * want
    bi = params_mod.init_layer_params(layers.GravesBidirectionalLSTM(
        n_in=4, n_out=6, weight_init="xavier", bias_init=0.5,
        forget_gate_bias_init=2.0), gen)
    for s in ("_f", "_b"):
        assert torch.equal(bi["b" + s][6:12], torch.full((6,), 2.0))
        assert torch.equal(bi["b" + s][:6], torch.full((6,), 0.5))
        assert not bi["pW" + s].any()


def test_fit_refuses_what_the_port_lacks(monkeypatch):
    # Dropout now trains: under truncated BPTT each chunk draws from a new
    # key, as the reference's scan does; under the reference's own masks
    # (the port's draw function swapped) the chunks equal its.
    monkeypatch.setattr(common, "draw_keep", lambda key, retain, shape,
                        device: torch.from_numpy(np.array(
                            jax.random.bernoulli(jnp.asarray(key.words),
                                                 retain, tuple(shape)))))
    jnet, pnet = _nets()
    for net in (jnet, pnet):
        net.conf.layers[0].dropout = 0.5
        net.conf.layers[1].dropout = 0.7
        net.conf.layers[1].use_drop_connect = True
    key0 = pnet._train_rng.copy()
    x, y = _batch(8)
    jnet.fit(JaxDataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score_value, jnet.score_value, **F32)
    _assert_trees(pnet.params_tree, _np_tree(jnet.params_tree), "params")
    key = key0
    for _ in range(-(-T // CHUNK)):
        key = prng.split(key)[0]
    np.testing.assert_array_equal(pnet._train_rng, key)
    x, y = _batch(8)
    conf = zoo.char_rnn(vocab_size=V, hidden=8)
    conf.global_conf.optimization_algo = "lbfgs"
    solved = MultiLayerNetwork(conf, device="cpu").init()
    solved.fit(DataSet(x, y))  # a solver trains now (one call, one batch)
    assert solved.iteration == 1 and np.isfinite(solved.score_value)
    # Layerwise pretraining is in: a char-RNN has no pretrainable layer,
    # so with `pretrain` set its fit is the plain fit.
    plain = MultiLayerNetwork(zoo.char_rnn(vocab_size=V, hidden=8),
                              device="cpu").init()
    conf = zoo.char_rnn(vocab_size=V, hidden=8)
    conf.pretrain = True
    pre = MultiLayerNetwork(conf, device="cpu").init()
    plain.fit(DataSet(x, y))
    pre.fit(DataSet(x, y))
    np.testing.assert_array_equal(pre.params(), plain.params())
    assert pre.iteration == plain.iteration == 1
    # The legacy dtype string "float16" is the float32 default, as in the
    # reference (its resolve_policy maps only "bfloat16" and "float64").
    conf = zoo.char_rnn(vocab_size=V, hidden=8, dtype="float16")
    half = MultiLayerNetwork(conf, device="cpu")
    assert half.dtype_policy.name == "float32"
    assert not half.dtype_policy.loss_scaling
    half.init(params=plain.params_tree)
    half.fit(DataSet(x, y))
    assert half.params_tree["layer_0"]["W"].dtype == torch.float32
    assert set(half.opt_state) == set(half.layer_keys)
