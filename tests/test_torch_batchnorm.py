"""Port BatchNorm (`norm_act.batchnorm_norm_act`, `BatchNormFn` and the
layer `batchnorm_apply`) against the JAX package, on the CPU.

- The plain version against `batchnorm_xla`, and against
  `batchnorm_norm_act` running its Pallas kernel in interpret mode
  (`DL4J_TPU_KERNEL_NORM_ACT=pallas`);
- the layer in training (single-pass batch statistics, EMA of the running
  statistics) and in inference (running statistics, where a bf16 x with f32
  statistics computes in f32 on both sides), forward and gradients against
  `jax.vjp`, the gradient through the batch statistics included;
- without a card, the kernel wrapper's arguments to its C entry: the
  inputs' own pointers and dtype codes (no copy, no cast), floats by
  value, any channel count, and the vectors it refuses.

Inputs come from one numpy RandomState and go to both packages.
Tolerances: f32 1e-5 (the JAX parity matrix's); bf16 4e-2 forward; f32
gradients 1e-4 (sums over the batch in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import norm_act as jax_norm_act
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu.nn.conf.layers import (
    BatchNormalization as JaxBatchNormalization,
)
from deeplearning4j_tpu.nn.layers import normalization as jax_normalization
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import norm_act
from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
from deeplearning4j_tpu_torch.nn.layers.normalization import batchnorm_apply

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=4e-2, atol=4e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _registry(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_KERNEL_NORM_ACT", raising=False)
    monkeypatch.delenv("DL4J_TPU_KERNELS", raising=False)
    registry.clear_cache()
    yield
    registry.clear_cache()


def _inputs(shape, seed=3):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return dict(x=rng.randn(*shape) * 2 + 0.5, mean=rng.randn(c) * 0.3,
                var=rng.rand(c) + 0.2, gamma=rng.rand(c) + 0.5,
                beta=rng.randn(c))


def _both(arrs, dtype, stat_dtype=None):
    """numpy inputs as (jax dict, torch dict); stats at `stat_dtype`."""
    sd = stat_dtype or dtype
    jd = {k: jnp.asarray(a, jnp.dtype(sd if k in ("mean", "var") else dtype))
          for k, a in arrs.items()}
    td = {k: torch.tensor(a, dtype=TORCH[sd if k in ("mean", "var")
                                         else dtype])
          for k, a in arrs.items()}
    return jd, td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("shape", [(2, 5, 5, 16), (7, 24), (3, 4, 8),
                                   # channel counts the kernel used to refuse
                                   (2, 4, 4, 3), (5, 10), (3, 2, 12)])
def test_plain_matches_batchnorm_xla(dtype, act, shape):
    jd, td = _both(_inputs(shape), dtype)
    want = jax_norm_act.batchnorm_xla(jd["x"], jd["mean"], jd["var"],
                                      jd["gamma"], jd["beta"], 1e-5, act)
    kernels.reset_counts()
    got = norm_act.batchnorm_norm_act(td["x"], td["mean"], td["var"],
                                      td["gamma"], td["beta"], 1e-5, act)
    assert kernels.counts()["plain_calls"]["batchnorm_norm_act"] == 1
    assert not any(kernels.counts()["launches"].values())
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["identity", "relu"])
def test_plain_matches_the_jax_pallas_kernel(monkeypatch, dtype, act):
    monkeypatch.setenv("DL4J_TPU_KERNEL_NORM_ACT", "pallas")
    registry.clear_cache()
    jd, td = _both(_inputs((2, 4, 4, 128), seed=4), dtype)
    want = jax_norm_act.batchnorm_norm_act(jd["x"], jd["mean"], jd["var"],
                                           jd["gamma"], jd["beta"], 1e-5, act)
    got = norm_act.batchnorm_norm_act(td["x"], td["mean"], td["var"],
                                      td["gamma"], td["beta"], 1e-5, act)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOLS[dtype])


def test_bf16_x_with_f32_running_stats_promotes_like_xla():
    # Inference under mixed bf16: the running stats stay f32, so the XLA
    # path (and the port's plain path) computes in f32.
    jd, td = _both(_inputs((2, 3, 3, 8), seed=5), "bfloat16",
                   stat_dtype="float32")
    want = jax_norm_act.batchnorm_xla(jd["x"], jd["mean"], jd["var"],
                                      jd["gamma"], jd["beta"], 1e-5, "relu")
    got = norm_act.batchnorm_norm_act(td["x"], td["mean"], td["var"],
                                      td["gamma"], td["beta"], 1e-5, "relu")
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _confs(**kw):
    return (JaxBatchNormalization(n_in=8, n_out=8, activation="relu", **kw),
            BatchNormalization(n_in=8, n_out=8, activation="relu", **kw))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("lock", [False, True])
def test_layer_forward_state_and_gradients_match_jax(train, lock):
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 3, 8) * 1.5 + 0.3
    gamma, beta = rng.rand(8) + 0.5, rng.randn(8) * 0.2
    mean, var = rng.randn(8) * 0.1, rng.rand(8) + 0.5
    w = rng.randn(4, 3, 3, 8)
    jconf, pconf = _confs(lock_gamma_beta=lock, gamma=1.5, beta=-0.25)
    jstate = {"mean": jnp.asarray(mean, jnp.float32),
              "var": jnp.asarray(var, jnp.float32)}
    pstate = {"mean": torch.tensor(mean, dtype=torch.float32),
              "var": torch.tensor(var, dtype=torch.float32)}

    def jloss(xv, g, b):
        params = {} if lock else {"gamma": g, "beta": b}
        out, new_state, _ = jax_normalization.batchnorm_apply(
            jconf, params, jstate, xv, train=train)
        return jnp.sum(out * w), (out, new_state)

    jx, jg, jb = (jnp.asarray(a, jnp.float32) for a in (x, gamma, beta))
    (_, (jout, jnew)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jx, jg, jb)

    px, pg, pb = (torch.tensor(a, dtype=torch.float32, requires_grad=True)
                  for a in (x, gamma, beta))
    params = {} if lock else {"gamma": pg, "beta": pb}
    pout, pnew = batchnorm_apply(pconf, params, pstate, px, train=train)
    leaves = [px] if lock else [px, pg, pb]
    pgrads = torch.autograd.grad((pout * torch.tensor(w)).sum(), leaves)

    np.testing.assert_allclose(pout.detach().numpy(), np.asarray(jout),
                               **TOLS["float32"])
    for k in ("mean", "var"):
        assert pnew[k].dtype == torch.float32 and not pnew[k].requires_grad
        np.testing.assert_allclose(pnew[k].numpy(), np.asarray(jnew[k]),
                                   **TOLS["float32"])
    for got, want in zip(pgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_the_gradient_flows_through_the_batch_statistics():
    # A version that detached mean and var would give another dx; the
    # JAX gradient above is the one with the statistics differentiated.
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.randn(6, 8) + 1.0, requires_grad=True)
    w = torch.tensor(rng.randn(6, 8))
    g, b = torch.ones(8, dtype=torch.float64), torch.zeros(8,
                                                          dtype=torch.float64)

    def dx(detach):
        mean = x.mean(0)
        var = (x * x).mean(0) - mean * mean
        if detach:
            mean, var = mean.detach(), var.detach()
        y = norm_act.batchnorm_norm_act(x, mean, var, g, b, 1e-5, "identity")
        return torch.autograd.grad((y * w).sum(), x)[0]

    through, cut = dx(False), dx(True)
    assert float((through - cut).abs().max()) > 0.1
    # Normalized output: its gradient sums to ~0 over the batch per channel.
    assert float(through.sum(0).abs().max()) < 1e-6


def test_bf16_training_stats_promote_into_the_f32_state():
    rng = np.random.RandomState(8)
    x = rng.randn(4, 2, 2, 8)
    _, pconf = _confs()
    pstate = {"mean": torch.zeros(8), "var": torch.ones(8)}
    params = {"gamma": torch.ones(8, dtype=torch.bfloat16),
              "beta": torch.zeros(8, dtype=torch.bfloat16)}
    out, new = batchnorm_apply(pconf, params, pstate,
                               torch.tensor(x, dtype=torch.bfloat16),
                               train=True)
    assert out.dtype == torch.bfloat16
    assert new["mean"].dtype == new["var"].dtype == torch.float32
    want = 0.1 * x.reshape(-1, 8).mean(0)
    np.testing.assert_allclose(new["mean"].numpy(), want, atol=1e-2)


def test_batchnorm_cpu_takes_the_plain_version_and_refuses_other_devices():
    x = torch.empty(3, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        norm_act.batchnorm_norm_act(x, x[0], x[0], x[0], x[0], 1e-5, "relu")
    with pytest.raises(ValueError, match="different devices"):
        norm_act.batchnorm_norm_act(torch.zeros(3, 8), x[0], x[0], 1.0, 0.0,
                                    1e-5, "relu")


def _fake_card(monkeypatch):
    """The wrapper's launch path without a card: CPU tensors pass for CUDA
    ones, and each C-entry call is checked against its ctypes signature
    and recorded (its arguments) instead of launched."""
    from deeplearning4j_tpu_torch.kernels import _build

    calls = []

    def fake_launch(name, *args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig)
        for a, t in zip(args, sig):
            assert isinstance(a, float if t is _build._F else int), (name, a)
        calls.append(args)

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(_build, "on_device", lambda i: torch.no_grad())
    monkeypatch.setattr(_build, "current_stream", lambda i: 0)
    return calls


def test_kernel_wrapper_passes_the_c_entry_its_signature(monkeypatch):
    # Without a card: the arguments the wrapper hands the C entry against
    # its ctypes signature. The vectors go as they are: their own pointers
    # and dtype codes (no copy, no cast), a float by value (kind 8).
    calls = _fake_card(monkeypatch)
    x = torch.zeros(2, 3, 3, 16, dtype=torch.bfloat16)
    mean, var = torch.zeros(16), torch.ones(16, dtype=torch.float16)
    before = kernels.launches["batchnorm_norm_act"].value
    norm_act._batchnorm_forward(x, mean, var, 1.5, 0.0, 1e-5, "relu")
    assert kernels.launches["batchnorm_norm_act"].value == before + 1
    (args,) = calls
    assert args[0] == x.data_ptr()
    assert args[1:5] == (mean.data_ptr(), var.data_ptr(), 0, 0)
    assert args[6:12] == (18, 16, 1e-5, 1, norm_act.DTYPE_CODES[x.dtype],
                          0 | 3 << 4 | 8 << 8 | 8 << 12)
    assert args[12:16] == (0.0, 0.0, 1.5, 0.0)
    # Any channel count: C = 12 in bf16 (no multiple of 8) is taken.
    x12, m12 = torch.zeros(4, 12, dtype=torch.bfloat16), torch.zeros(12)
    norm_act._batchnorm_forward(x12, m12, torch.ones(12), 1.0, 0.0, 1e-5,
                                "relu")
    assert calls[-1][0] == x12.data_ptr() and calls[-1][6:8] == (4, 12)
    assert kernels.launches["batchnorm_norm_act"].value == before + 2


def test_kernel_wrapper_keeps_f16_statistics_in_f32(monkeypatch):
    # f16 x: the wrapper hands the C entry f16's code and the f32 vectors
    # as they are (never rounded to f16: the kernel reads them in f32), the
    # f16 ones as f16 (widened exactly), a 0-d tensor with the broadcast
    # kind.
    calls = _fake_card(monkeypatch)
    x = torch.zeros(2, 3, 3, 16, dtype=torch.float16)
    mean = torch.full((16,), 1.0 / 3.0)  # no f16 value
    var = torch.ones(16, dtype=torch.float16)
    gamma = torch.tensor(2.0)
    norm_act._batchnorm_forward(x, mean, var, gamma, 0.25, 1e-5, "relu")
    (args,) = calls
    assert args[10] == norm_act.DTYPE_CODES[torch.float16] == 3
    assert args[1:4] == (mean.data_ptr(), var.data_ptr(), gamma.data_ptr())
    assert args[11] == 0 | 3 << 4 | (0 | 4) << 8 | 8 << 12
    assert args[15] == 0.25
    assert mean.dtype == torch.float32 and torch.equal(
        mean, torch.full((16,), 1.0 / 3.0))


@pytest.mark.parametrize("bad,match", [
    (torch.zeros(8), "contiguous \\[16\\] tensor"),
    (torch.zeros(16, 2)[:, 0], "contiguous \\[16\\] tensor"),
    (torch.zeros(1), "contiguous \\[16\\] tensor"),
    (torch.zeros(16, dtype=torch.float64), "float32, bfloat16 or float16"),
    ("1.0", "a tensor or a float"),
])
def test_kernel_wrapper_refuses_a_vector_it_cannot_take(monkeypatch, bad,
                                                        match):
    calls = _fake_card(monkeypatch)
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    before = kernels.launches["batchnorm_norm_act"].value
    with pytest.raises((ValueError, TypeError), match=match):
        norm_act._batchnorm_forward(x, torch.zeros(16), bad, 1.0, 0.0, 1e-5,
                                    "relu")
    assert not calls
    assert kernels.launches["batchnorm_norm_act"].value == before
