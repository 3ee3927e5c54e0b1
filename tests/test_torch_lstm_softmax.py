"""Softmax and the user's activations in the LSTM cell (row 10), on the CPU,
against the JAX package's `xla_cell` (deeplearning4j_tpu/kernels/
lstm_cell.py:86): a softmax gate and a softmax cell activation, with and
without peepholes and mask, in f32 (rtol = atol = 1e-5: the same ops, sums
in another order) and float64 (1e-12); their gradients against `jax.vjp`;
a registered activation and a callable through the cell and through a
GravesLSTM layer; and a registered name through the conf's JSON. On the
card these run the "z out" launch and the row kernel (`lstm_cell_rows`),
or the user's function after the "z out" launch: the wrapper's arguments
for those routes are checked here without a card. And the limits that
`chip_smoke.py` and the card tests hold the softmax cell to
(`SOFTMAX_TOL`, by `row_rel_err`) at the card's shape: a sound cell (the
outputs computed in float64 and rounded once to the dtype) reads below
each, every planted fault (`softmax_faults`) above."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import lstm_cell as jax_lc
from deeplearning4j_tpu.nn import activations as jax_acts
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.inputs import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net import (
    NeuralNetConfiguration as JaxNNC,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.kernels import lstm_cell as lc
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "float64": dict(rtol=1e-12, atol=1e-12)}
ACTS = [("softmax", "tanh"), ("sigmoid", "softmax"), ("softmax", "softmax")]
PEEP_MASK = [(True, False), (False, False), (True, True), (False, True)]


def _inputs(b, n, peephole, masked, dtype, seed=0):
    rng = np.random.RandomState(seed)
    d = dict(xw=rng.randn(b, 4 * n), h=rng.randn(b, n), c=rng.randn(b, n),
             rw=rng.randn(n, 4 * n) * n ** -0.5,
             pw=rng.randn(3 * n) * 0.3 if peephole else None,
             m=(rng.rand(b) < 0.6).astype(float) if masked else None)
    return {k: None if v is None else v.astype(dtype) for k, v in d.items()}


def _want(d, gate, act, jgate=None, jact=None):
    n = d["h"].shape[1]
    cell = jax_lc.xla_cell(jgate or jax_acts.resolve(gate),
                           jact or jax_acts.resolve(act),
                           d["pw"] is not None)
    pw = None if d["pw"] is None else jnp.asarray(d["pw"])
    return cell(jnp.asarray(d["xw"]), jnp.asarray(d["h"]),
                jnp.asarray(d["c"]), jnp.asarray(d["rw"]),
                None if pw is None else (pw[:n], pw[n:2 * n], pw[2 * n:]),
                None if d["m"] is None else jnp.asarray(d["m"]))


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(d):
    return [None if d[k] is None else torch.from_numpy(d[k])
            for k in ("xw", "h", "c", "rw", "pw", "m")]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("peephole,masked", PEEP_MASK)
@pytest.mark.parametrize("gate,act", ACTS)
def test_softmax_cell_matches_xla_cell(gate, act, peephole, masked, dtype):
    d = _inputs(5, 7, peephole, masked, dtype)
    got = lc.lstm_cell(*_port(d), gate, act)
    for g, w in zip(got, _want(d, gate, act)):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "float64"])
@pytest.mark.parametrize("peephole,masked", PEEP_MASK)
@pytest.mark.parametrize("gate,act", ACTS)
def test_softmax_limits_pass_a_sound_cell_and_catch_planted_faults(
        gate, act, peephole, masked, dtype):
    smoke = _chip_smoke()
    dt = getattr(torch, dtype)
    d = _inputs(32, 256, peephole, masked, "float64", seed=7)
    args = [None if a is None else a.to(dt) for a in _port(d)]
    low = dtype in ("bfloat16", "float16")
    ref = [None if a is None else (a.float() if low else a) for a in args]
    want = lc.lstm_cell_plain(*ref, gate, act)
    sound = [t.to(dt) for t in lc.lstm_cell_plain(
        *(None if a is None else a.double() for a in args), gate, act)]
    tol = smoke.SOFTMAX_TOL[dtype]
    assert smoke.row_rel_err(sound, want) <= tol
    faults = smoke.softmax_faults(torch, lc, ref, gate, act, dtype)
    assert len(faults) == 2 + peephole + masked
    for fault, out in faults.items():
        if fault not in smoke.SOFTMAX_BLIND.get(dtype, ()):
            assert smoke.row_rel_err(out, want) > tol, fault


@pytest.mark.parametrize("peephole,masked", [(True, True), (False, False)])
@pytest.mark.parametrize("gate,act", ACTS)
def test_softmax_cell_gradients_match_jax(gate, act, peephole, masked):
    d = _inputs(3, 5, peephole, masked, "float64", seed=1)
    n = 5
    rng = np.random.RandomState(2)
    cots = [rng.randn(3, n) for _ in range(3)]
    names = ["xw", "h", "c", "rw"] + (["pw"] if peephole else [])

    def f(*prim):
        e = dict(d, **dict(zip(names, prim)))
        return _want(e, gate, act)
    _, vjp = jax.vjp(f, *(jnp.asarray(d[k]) for k in names))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    args = _port(d)
    leaves = [a.requires_grad_(True) for a in args[:5] if a is not None]
    outs = lc.lstm_cell(*args, gate, act)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-12)


@pytest.fixture
def registered(monkeypatch):
    """'halfsig' registered in both packages (and taken out afterwards)."""
    monkeypatch.setitem(jax_acts._REGISTRY, "halfsig",
                        lambda x: 0.5 * jax.nn.sigmoid(x))
    monkeypatch.setitem(activations._REGISTRY, "halfsig",
                        lambda x: 0.5 * torch.sigmoid(x))


@pytest.mark.parametrize("role", ["gate", "cell"])
def test_registered_and_callable_activations_match_xla_cell(registered,
                                                            role):
    d = _inputs(4, 6, True, True, "float32", seed=3)
    gate, act = ("halfsig", "tanh") if role == "gate" else ("sigmoid",
                                                            "halfsig")
    want = _want(d, gate, act)
    for spec in ("halfsig", "HalfSig", lambda x: 0.5 * torch.sigmoid(x)):
        g, a = (spec, act) if role == "gate" else (gate, spec)
        got = lc.lstm_cell(*_port(d), g, a)
        for t, w in zip(got, want):
            np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                       **TOL["float32"])


def test_register_resolves_callables_and_refuses_unknown_names():
    fn = lambda x: x * 3  # noqa: E731
    assert activations.resolve(fn) is fn
    assert activations.builtin("tanh") == "tanh"
    assert activations.builtin("TANH") == "tanh"
    assert activations.builtin(fn) is None
    with pytest.raises(ValueError, match="Unknown activation"):
        activations.resolve("no_such_activation")
    with pytest.raises(ValueError, match="Unknown activation"):
        lc.lstm_cell(*_port(_inputs(2, 3, False, False, "float32")),
                     "sigmoid", "no_such_activation")


def test_register_matches_the_reference_and_shadows_a_builtin(monkeypatch):
    # The reference's test_custom_registration; a name registered over a
    # built-in one is the user's function: no kernel code for it.
    monkeypatch.setitem(activations._REGISTRY, "double", lambda x: 2 * x)
    x = torch.tensor([3.0])
    assert float(activations.resolve("double")(x)) == 6.0
    monkeypatch.setitem(activations._REGISTRY, "tanh", lambda x: 2 * x)
    assert activations.builtin("tanh") is None
    assert lc._act_code("tanh") is None
    monkeypatch.undo()
    activations.register("mine", lambda x: x)
    try:
        assert lc._act_code("MINE") is None
        assert lc._act_code("softmax") == lc.SOFTMAX_CODE
        assert lc._act_code(None) == lc.ACT_CODES["identity"]
    finally:
        del activations._REGISTRY["mine"]


def _lstm_conf(nnc, L, it, gate, act="tanh"):
    return (nnc.builder().seed(9).dtype("float64").list()
            .layer(L.GravesLSTM(n_out=6, activation=act,
                                gate_activation=gate))
            .layer(L.RnnOutputLayer(n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(it.recurrent(4)).build())


@pytest.mark.parametrize("gate,act", [("softmax", "tanh"),
                                      ("sigmoid", "softmax"),
                                      ("halfsig", "tanh")])
def test_graves_lstm_layer_matches_the_reference(registered, gate, act):
    # Through the conf's JSON (the registered name travels as a name), the
    # reference's params, a masked batch: output and score to 1e-12.
    jconf = _lstm_conf(JaxNNC, jax_layers, JaxInputType, gate, act)
    jnet = JaxMLN(jconf).init()
    text = jconf.to_json()
    pconf = MultiLayerConfiguration.from_json(text)
    assert pconf.to_json() == text
    assert pconf.layers[0].gate_activation == gate
    pnet = MultiLayerNetwork(pconf, device="cpu").init(
        params=interop.params_from_numpy(
            {k: {n: np.array(a) for n, a in p.items()}
             for k, p in jnet.params_tree.items()}))
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 4)
    y = np.eye(3)[rng.randint(0, 3, (3, 5))]
    m = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], float)
    np.testing.assert_allclose(pnet.output(x, features_mask=m),
                               np.asarray(jnet.output(x, features_mask=m)),
                               rtol=1e-12, atol=1e-12)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet

    np.testing.assert_allclose(pnet.score(DataSet(x, y, m, m)),
                               float(jnet.score(JDataSet(x, y, m, m))),
                               rtol=1e-12)


@pytest.mark.parametrize("gate,act,route", [
    ("softmax", "tanh", "rows"), ("sigmoid", "softmax", "rows"),
    ("halfsig", "tanh", "callable"), ("sigmoid", "tanh", "cell")])
def test_the_wrapper_picks_the_route_without_a_card(registered, monkeypatch,
                                                    gate, act, route):
    # What the wrapper would launch on the card: the C entries it calls,
    # in order, and (callable) the tail it runs as torch ops.
    from deeplearning4j_tpu_torch.kernels import _build

    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(kernels, "placement", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "on_device", lambda i: torch.no_grad())
    monkeypatch.setattr(_build, "current_stream", lambda i: 0)
    d = _inputs(3, 4, True, False, "float32")
    before = kernels.counts()
    h, c, out = lc.lstm_cell(*_port(d), gate, act)
    after = kernels.counts()
    names = [n for n, _ in calls]
    if route == "cell":
        assert names == ["dl4j_lstm_cell"]
    elif route == "rows":
        assert names == ["dl4j_lstm_cell", "dl4j_lstm_cell_rows"]
        assert (after["launches"]["lstm_cell_rows"]
                == before["launches"]["lstm_cell_rows"] + 1)
    else:
        assert names == ["dl4j_lstm_cell"]
        assert (after["variants"]["lstm_cell"]["callable"]
                == before["variants"]["lstm_cell"]["callable"] + 1)
    zout = lc._CellParams.from_address(calls[0][1][9]).zout
    assert zout == (route != "cell")
    assert h.shape == c.shape == out.shape == (3, 4)
