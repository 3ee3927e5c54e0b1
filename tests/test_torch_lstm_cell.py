"""The port's LSTM cell (`kernels/lstm_cell.py`) against the JAX package's,
on the CPU, and the activations the recurrent confs name.

- `lstm_cell_plain` against JAX `xla_cell` (the XLA scan body) and against
  JAX's Pallas cell run in interpret mode (forced with
  `DL4J_TPU_KERNEL_LSTM_CELL=pallas`, as `tests/test_kernels.py` forces
  it): peephole x masked x {f32, bf16}, b in {1, 3}, n in {8, 200}, each
  cell activation. Tolerances rtol = atol: f32 1e-5 (the same ops; the
  matmul sums in another order); bf16 4e-2, as the JAX package's own
  parity matrix (the Pallas cell keeps z in f32 where XLA rounds it).
- Every elementwise activation (16 names) as gate and as cell activation,
  f32, bf16 and f16, against `xla_cell` (`ROUNDOFF`: f32 2e-4, bf16 and
  f16 8 units of their roundoff).
- `LSTMCellFn`'s gradients (the plain forward and the VJP of the plain ops)
  against `jax.vjp` of `xla_cell`, f32, rtol = atol = 1e-5.
- The wrapper takes the plain version only for CPU tensors; for CUDA
  tensors it hands the C entry its arguments (checked against the ctypes
  signature without a card), and a card case (marked `cuda`) shows it
  refusing a gradient outside the Function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import lstm_cell as jax_cell
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu.nn import activations as jax_activations
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import lstm_cell as lc
from deeplearning4j_tpu_torch.nn import activations

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _inputs(b, n, peephole, masked, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        xw=rng.randn(b, 4 * n).astype(np.float32),
        h=rng.randn(b, n).astype(np.float32),
        c=rng.randn(b, n).astype(np.float32),
        rw=(rng.randn(n, 4 * n) * n ** -0.5).astype(np.float32),
        pw=(rng.randn(3 * n) * 0.3).astype(np.float32) if peephole else None,
        m=(rng.rand(b) < 0.6).astype(np.float32) if masked else None)


def _port(a, dtype):
    return None if a is None else torch.tensor(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, jnp.dtype(dtype))


def _jax_args(d, dtype):
    n = d["h"].shape[1]
    pw = _jax(d["pw"], dtype)
    return (_jax(d["xw"], dtype), _jax(d["h"], dtype), _jax(d["c"], dtype),
            _jax(d["rw"], dtype),
            None if pw is None else (pw[:n], pw[n:2 * n], pw[2 * n:]),
            _jax(d["m"], dtype))


def _port_args(d, dtype):
    return [_port(d[k], dtype) for k in ("xw", "h", "c", "rw", "pw", "m")]


def _check(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("peephole,masked", [
    (True, False), (False, False), (True, True), (False, True)])
@pytest.mark.parametrize("b,n", [(1, 8), (3, 8), (1, 200), (3, 200)])
def test_plain_cell_matches_xla_cell(dtype, peephole, masked, b, n):
    d = _inputs(b, n, peephole, masked)
    want = jax_cell.xla_cell(jax.nn.sigmoid, jnp.tanh, peephole)(
        *_jax_args(d, dtype))
    kernels.reset_counts()
    got = lc.lstm_cell(*_port_args(d, dtype))
    assert kernels.counts()["plain_calls"]["lstm_cell"] == 1
    assert not any(kernels.counts()["launches"].values())
    _check(got, want, dtype)


@pytest.mark.parametrize("act,gate", [
    ("tanh", "sigmoid"), ("sigmoid", "sigmoid"), ("relu", "sigmoid"),
    ("identity", "sigmoid"), ("tanh", "hardsigmoid"), ("softsign", "sigmoid")])
def test_plain_cell_activations_match_xla_cell(act, gate):
    d = _inputs(3, 8, True, True, seed=1)
    want = jax_cell.xla_cell(jax_activations.resolve(gate),
                             jax_activations.resolve(act), True)(
        *_jax_args(d, "float32"))
    got = lc.lstm_cell(*_port_args(d, "float32"), gate, act)
    _check(got, want, "float32")


# The cell's ops between the shared inputs and an output (the product's
# rounding, the peephole adds, three gates, two products, the sum, the
# activation, the mask blend) each round to bf16 or f16 in the port, while
# XLA keeps f32 inside a fused chain: up to a few units of roundoff u apart
# (measured: 4u for cube in bf16). 8u a value, relative to |value| + 1.
ROUNDOFF = {"float32": dict(rtol=2e-4, atol=2e-4),
            "bfloat16": dict(rtol=8 * 2.0 ** -8, atol=8 * 2.0 ** -8),
            "float16": dict(rtol=8 * 2.0 ** -11, atol=8 * 2.0 ** -11)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("role", ["gate", "cell"])
@pytest.mark.parametrize("name", list(lc.ACT_CODES))
def test_every_elementwise_activation_matches_xla_cell(name, role, dtype):
    # Each of the kernel's 16 names as the gate activation (cell tanh) and
    # as the cell activation (sigmoid gates), peepholes and a mask.
    gate, act = (name, "tanh") if role == "gate" else ("sigmoid", name)
    d = _inputs(3, 8, True, True, seed=5)
    want = jax_cell.xla_cell(jax_activations.resolve(gate),
                             jax_activations.resolve(act), True)(
        *_jax_args(d, dtype))
    got = lc.lstm_cell_plain(*_port_args(d, dtype), gate, act)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   **ROUNDOFF[dtype])


def test_the_kernel_codes_cover_every_elementwise_activation():
    assert set(lc.ACT_CODES) == set(activations._BUILTIN) - {"softmax"}
    assert sorted(lc.ACT_CODES.values()) == list(range(16))


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_KERNEL_LSTM_CELL", "pallas")
    registry.clear_cache()
    yield
    registry.clear_cache()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("peephole,masked", [
    (True, False), (False, False), (True, True), (False, True)])
def test_plain_cell_matches_the_pallas_cell(pallas_interpret, dtype,
                                            peephole, masked):
    b, n = 3, 8
    d = _inputs(b, n, peephole, masked, seed=2)
    cell = jax_cell.resolve_cell(
        batch=b, n_out=n, dtype=dtype, peephole=peephole, masked=masked,
        gate_activation="sigmoid", activation="tanh",
        gate_act=jax.nn.sigmoid, cell_act=jnp.tanh)
    want = cell(*_jax_args(d, dtype))
    _check(lc.lstm_cell(*_port_args(d, dtype)), want, dtype)


@pytest.mark.parametrize("peephole,masked", [
    (True, False), (False, False), (True, True), (False, True)])
def test_lstm_cell_fn_gradients_match_jax_vjp(peephole, masked):
    b, n = 3, 8
    d = _inputs(b, n, peephole, masked, seed=3)
    rng = np.random.RandomState(4)
    cots = [rng.randn(b, n).astype(np.float32) for _ in range(3)]
    xla = jax_cell.xla_cell(jax.nn.sigmoid, jnp.tanh, peephole)
    ja = _jax_args(d, "float32")
    m = ja[5]
    if peephole:
        def f(xw, h, c, rw, pw):
            return xla(xw, h, c, rw, (pw[:n], pw[n:2 * n], pw[2 * n:]), m)
        primals = ja[:4] + (jnp.asarray(d["pw"]),)
    else:
        def f(xw, h, c, rw):
            return xla(xw, h, c, rw, None, m)
        primals = ja[:4]
    _, vjp = jax.vjp(f, *primals)
    want = vjp(tuple(jnp.asarray(c) for c in cots))

    args = _port_args(d, "float32")
    leaves = [a.requires_grad_(True) for a in args[:5] if a is not None]
    kernels.reset_counts()
    outs = lc.lstm_cell(*args)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots))
    got = torch.autograd.grad(loss, leaves)
    # The forward is one plain call; the backward's recompute is not.
    assert kernels.counts()["plain_calls"]["lstm_cell"] == 1
    assert outs[0].grad_fn is not None
    assert type(outs[0].grad_fn).__name__ == "LSTMCellFnBackward"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **TOL["float32"])


def test_cpu_takes_the_plain_version_and_refuses_other_devices():
    x = torch.empty(2, 32, device="meta")
    h = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        lc.lstm_cell(x, h, h, torch.empty(8, 32, device="meta"), None, None)
    with pytest.raises(ValueError, match="different devices"):
        lc.lstm_cell(torch.zeros(2, 32), h, h, torch.zeros(8, 32), None,
                     None)


def test_kernel_wrapper_passes_the_c_entry_its_signature(monkeypatch):
    # Without a card: what the wrapper would hand the C entry, against its
    # ctypes signature; xw_t is a time step of [b, t, 4n] (rows t*4n apart).
    from deeplearning4j_tpu_torch.kernels import _build

    calls = []

    def fake_launch(name, *args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig)
        for a, t in zip(args, sig):
            if t is _build._P:
                assert a is None or isinstance(a, int), a
            else:
                assert isinstance(a, int), (name, a)
        calls.append(args)

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(kernels, "placement", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "on_device", lambda i: torch.no_grad())
    monkeypatch.setattr(_build, "current_stream", lambda i: 0)
    b, n, t = 3, 5, 4
    xw = torch.zeros(b, t, 4 * n).unbind(1)[2]
    h, c = torch.zeros(b, n), torch.zeros(b, n)
    rw, pw = torch.zeros(n, 4 * n), torch.zeros(3 * n)
    before = kernels.launches["lstm_cell"].value
    out = lc.lstm_cell(xw, h, c, rw, pw, None, "sigmoid", "relu")
    assert [tuple(o.shape) for o in out] == [(b, n)] * 3
    assert kernels.launches["lstm_cell"].value == before + 1
    (args,) = calls
    assert args[5] is None and args[4] is not None
    # Without a mask out is h, as in the plain version: no out pointer.
    assert out[2] is out[0] and args[8] is None
    params = lc._CellParams.from_address(args[9])
    assert (params.xw_stride, params.b, params.n, params.act, params.gate,
            params.dtype) == (t * 4 * n, b, n, lc.ACT_CODES["relu"],
                              lc.ACT_CODES["sigmoid"],
                              lc.DTYPE_CODES[torch.float32])
    masked = lc.lstm_cell(xw, h, c, rw, None, torch.ones(b), "sigmoid",
                          "tanh")
    assert calls[1][4] is None and calls[1][5] is not None
    assert masked[2] is not masked[0] and calls[1][8] is not None
    # A Keras import's hard-sigmoid gates launch, with their gate code;
    # softmax (not elementwise) takes the "z out" launch, whose workspace
    # comes as `out`, then the row kernel with softmax's code.
    lc.lstm_cell(xw, h, c, rw, pw, None, "hardsigmoid", "tanh")
    params = lc._CellParams.from_address(calls[2][9])
    assert (params.gate, params.act) == (lc.ACT_CODES["hardsigmoid"],
                                         lc.ACT_CODES["tanh"])
    for gate, act in (("softmax", "tanh"), ("sigmoid", "softmax")):
        del calls[3:]
        lc.lstm_cell(xw, h, c, rw, pw, None, gate, act)
        zout, rows = calls[3], calls[4]
        assert lc._CellParams.from_address(zout[9]).zout == 1
        assert zout[6] is None and zout[8] is not None
        prm = lc._CellParams.from_address(rows[8])
        assert (prm.gate, prm.act) == tuple(
            lc.SOFTMAX_CODE if a == "softmax" else lc.ACT_CODES[a]
            for a in (gate, act))
    del calls[3:]
    with pytest.raises(ValueError, match="Unknown activation"):
        lc.lstm_cell(xw, h, c, rw, pw, None, "sigmoid", "nope")
    with pytest.raises(ValueError, match="pW"):
        lc.lstm_cell(xw, h, c, rw, pw[:n], None)
    # float64 launches the kernel's f64 form.
    lc.lstm_cell(*(a.double() for a in (xw, h, c, rw, pw)), None)
    assert lc._CellParams.from_address(calls[3][9]).dtype == 4
    with pytest.raises(TypeError, match="float32, bfloat16, float16 or"):
        lc.lstm_cell(*(a.to(torch.complex64) for a in (xw, h, c, rw, pw)),
                     None)
    lc.lstm_cell(*(a.half() for a in (xw, h, c, rw, pw)), None)
    params = lc._CellParams.from_address(calls[4][9])
    assert params.dtype == lc.DTYPE_CODES[torch.float16] == 3


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_gradient_outside_the_function():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    xw = torch.zeros(2, 32, device=dev)
    h = torch.zeros(2, 8, device=dev)
    rw = torch.zeros(8, 32, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        lc._cell_forward(xw, h, h, rw, None, None, "sigmoid", "tanh")
    out = lc.lstm_cell(xw, h, h, rw, None, None)  # through LSTMCellFn
    assert out[0].requires_grad


@pytest.mark.parametrize("name", sorted(activations._REGISTRY))
def test_activations_match_jax(name):
    x = np.linspace(-4, 4, 41).astype(np.float32)
    want = np.asarray(jax_activations.resolve(name)(jnp.asarray(x)))
    got = activations.resolve(name)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
