"""Port `bottleneck_block` (CPU: its plain versions) against the JAX
package's `bottleneck_forward`, run as its own tests run it
(tests/test_bottleneck_block.py): through the XLA composite
(`DL4J_TPU_KERNEL_BOTTLENECK_BLOCK=xla`) and through the Pallas bodies in
interpret mode (`=pallas`).

Covered: train and inference, projecting and identity shortcuts, strides 1
and 2 (odd and even sizes), f32 and bf16, int8 inference (all branches
quantized, and a mixed tree), `BottleneckFn`'s gradients against
`jax.grad` through the batch statistics, and the layer's EMA.

Tolerances are those of the JAX package's parity tests: f32 rtol = atol =
2e-5, bf16 6e-2 (the XLA composite rounds each conv output and statistic
to bf16, the Pallas body keeps f32); f32 gradients 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import bottleneck_block as jax_bb
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu.nn.conf.layers import (
    BottleneckBlock as JaxBottleneckBlock,
)
from deeplearning4j_tpu.nn.layers import bottleneck as jax_layer
from deeplearning4j_tpu_torch import interop, kernels
from deeplearning4j_tpu_torch.kernels import bottleneck_block as bb
from deeplearning4j_tpu_torch.nn.conf.layers import BottleneckBlock
from deeplearning4j_tpu_torch.nn.layers.bottleneck import bottleneck_apply

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=6e-2, atol=6e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _registry(monkeypatch):
    for var in ("DL4J_TPU_KERNELS", "DL4J_TPU_KERNEL_BOTTLENECK_BLOCK",
                "DL4J_TPU_KERNEL_NORM_ACT"):
        monkeypatch.delenv(var, raising=False)
    registry.clear_cache()
    yield
    registry.clear_cache()


def _arrays(seed, *, b=2, h=6, filters=2, project=False):
    """numpy x, params and running state of one block (the identity
    shortcut needs Cin = 4 * filters)."""
    rng = np.random.RandomState(seed)
    f1, f3 = filters, 4 * filters
    cin = f3
    x = rng.randn(b, h, h, cin)
    shapes = {"a": (1, 1, cin, f1), "b": (3, 3, f1, f1), "c": (1, 1, f1, f3)}
    if project:
        shapes["proj"] = (1, 1, cin, f3)
    params, state = {}, {}
    for n, s in shapes.items():
        params[f"W_{n}"] = rng.randn(*s) * 0.3
        params[f"gamma_{n}"] = rng.rand(s[-1]) + 0.5
        params[f"beta_{n}"] = rng.randn(s[-1]) * 0.1
        state[f"mean_{n}"] = rng.randn(s[-1]) * 0.1
        state[f"var_{n}"] = rng.rand(s[-1]) + 0.5
    return x, params, state


def _jax(monkeypatch, mode, x, params, state, dtype, **kw):
    monkeypatch.setenv("DL4J_TPU_KERNEL_BOTTLENECK_BLOCK", mode)
    registry.clear_cache()
    jd = jnp.dtype(dtype)
    jp = {k: jnp.asarray(a, jnp.float32 if k.endswith("__scale") else
                         (a.dtype if a.dtype == np.int8 else jd))
          for k, a in params.items()}
    js = {k: jnp.asarray(a, jnp.float32) for k, a in state.items()}
    return jax_bb.bottleneck_forward(jnp.asarray(x, jd), jp, js, eps=1e-5,
                                     activation="relu", **kw)


def _port(x, params, state, dtype, **kw):
    td = TORCH[dtype]
    pp = {k: (torch.tensor(a) if a.dtype == np.int8 else
              torch.tensor(a, dtype=torch.float32 if k.endswith("__scale")
                           else td))
          for k, a in params.items()}
    ps = {k: torch.tensor(a, dtype=torch.float32) for k, a in state.items()}
    return bb.bottleneck_forward(torch.tensor(x, dtype=td), pp, ps, eps=1e-5,
                                 activation="relu", **kw)


CASES = [(False, (1, 1), 6), (True, (1, 1), 6), (True, (2, 2), 6),
         (True, (2, 2), 7)]


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("project,stride,h", CASES)
def test_train_forward_and_stats_match_jax(monkeypatch, mode, dtype, project,
                                           stride, h):
    x, params, state = _arrays(21, h=h, project=project)
    kw = dict(stride=stride, project=project, train=True)
    jy, jstats = _jax(monkeypatch, mode, x, params, state, dtype, **kw)
    kernels.reset_counts()
    py, pstats = _port(x, params, state, dtype, **kw)
    assert kernels.counts()["plain_calls"]["bottleneck_train"] == 1
    assert not any(kernels.counts()["launches"].values())
    assert py.dtype == TORCH[dtype] and tuple(py.shape) == jy.shape
    np.testing.assert_allclose(py.float().numpy(), np.asarray(jy, np.float32),
                               **TOLS[dtype])
    assert set(pstats) == set(jstats) == set(bb.stat_keys(project))
    for k, v in jstats.items():
        np.testing.assert_allclose(pstats[k].float().numpy(),
                                   np.asarray(v, np.float32), **TOLS[dtype])


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("project,stride,h", CASES)
def test_infer_forward_matches_jax(monkeypatch, mode, dtype, project, stride,
                                   h):
    x, params, state = _arrays(22, h=h, project=project)
    kw = dict(stride=stride, project=project, train=False)
    jy, jstats = _jax(monkeypatch, mode, x, params, state, dtype, **kw)
    kernels.reset_counts()
    py, pstats = _port(x, params, state, dtype, **kw)
    assert jstats is None and pstats is None
    assert kernels.counts()["plain_calls"]["bottleneck_infer"] == 1
    np.testing.assert_allclose(py.float().numpy(), np.asarray(jy, np.float32),
                               **TOLS[dtype])


def _quantize(params, names):
    out = dict(params)
    for n in names:
        w = params[f"W_{n}"]
        scale = np.abs(w).reshape(-1, w.shape[-1]).max(0) / 127.0
        out[f"W_{n}"] = np.round(w / scale).astype(np.int8)
        out[f"W_{n}__scale"] = scale.astype(np.float32)
    return out


@pytest.mark.parametrize("mode", ["xla", "pallas"])
@pytest.mark.parametrize("names", [("a", "b", "c", "proj"), ("b",)],
                         ids=["all-int8", "mixed"])
def test_int8_inference_matches_jax(monkeypatch, mode, names):
    x, params, state = _arrays(23, project=True)
    q = _quantize(params, names)
    kw = dict(stride=(2, 2), project=True, train=False)
    jy, _ = _jax(monkeypatch, mode, x, q, state, "float32", **kw)
    py, _ = _port(x, q, state, "float32", **kw)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOLS["float32"])
    if names == ("a", "b", "c", "proj"):
        with pytest.raises(ValueError, match="int8"):
            _port(x, q, state, "float32", stride=(2, 2), project=True,
                  train=True)


@pytest.mark.parametrize("project,stride", [(True, (2, 2)), (False, (1, 1))])
def test_bottleneck_fn_gradients_match_jax(project, stride):
    x, params, state = _arrays(24, h=5, project=project)
    w = np.random.RandomState(25).randn(2, -(-5 // stride[0]),
                                        -(-5 // stride[1]), 8)
    names = sorted(params)

    def jloss(xv, *leaves):
        y, stats = jax_bb.bottleneck_forward(
            xv, dict(zip(names, leaves)), {}, stride=stride, project=project,
            eps=1e-5, activation="relu", train=True)
        return jnp.sum(y * w)

    jleaves = [jnp.asarray(params[k], jnp.float32) for k in names]
    jgrads = jax.grad(jloss, argnums=tuple(range(len(names) + 1)))(
        jnp.asarray(x, jnp.float32), *jleaves)

    px = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    pp = {k: torch.tensor(params[k], dtype=torch.float32, requires_grad=True)
          for k in names}
    kernels.reset_counts()
    y, stats = bb.bottleneck_forward(px, pp, {}, stride=stride,
                                     project=project, eps=1e-5,
                                     activation="relu", train=True)
    assert all(not s.requires_grad for s in stats.values())
    pgrads = torch.autograd.grad((y * torch.tensor(w)).sum(),
                                 [px] + [pp[k] for k in names])
    assert kernels.counts()["plain_calls"]["bottleneck_train"] == 1
    for got, want, k in zip(pgrads, jgrads, ["x"] + names):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=k, **GRAD_TOL)


def test_layer_ema_matches_jax():
    x, params, state = _arrays(26, project=True)
    params = {k: a.astype(np.float32) for k, a in params.items()}
    jconf = JaxBottleneckBlock(n_in=8, n_out=8, filters=2, stride=(2, 2),
                               project=True, activation="relu")
    pconf = BottleneckBlock(n_in=8, n_out=8, filters=2, stride=(2, 2),
                            project=True, activation="relu")
    jy, jnew, _ = jax_layer.bottleneck_apply(
        jconf, {k: jnp.asarray(a, jnp.float32) for k, a in params.items()},
        {k: jnp.asarray(a, jnp.float32) for k, a in state.items()},
        jnp.asarray(x, jnp.float32), train=True)
    py, pnew = bottleneck_apply(
        pconf, interop.params_from_numpy({"v": params})["v"],
        {k: torch.tensor(a, dtype=torch.float32) for k, a in state.items()},
        torch.tensor(x, dtype=torch.float32), train=True)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOLS["float32"])
    assert set(pnew) == set(jnew) == set(pconf.state_shapes())
    for k in jnew:
        assert pnew[k].dtype == torch.float32
        np.testing.assert_allclose(pnew[k].numpy(), np.asarray(jnew[k]),
                                   **TOLS["float32"])
    # Inference (or is_minibatch=False) leaves the state as it is.
    _, same = bottleneck_apply(pconf, interop.params_from_numpy(
        {"v": params})["v"], pnew, torch.tensor(x, dtype=torch.float32))
    assert same is pnew


def test_identity_shortcut_shape_is_checked_on_the_card_path_only():
    # The plain path raises as torch does on a shape mismatch; the kernel
    # wrapper states the rule (checked without a card here).
    ws = {"a": torch.zeros(1, 1, 8, 4), "c": torch.zeros(1, 1, 4, 16)}
    with pytest.raises(ValueError, match="identity shortcut"):
        bb._check(torch.zeros(1, 4, 4, 8), ws, (1, 1), False)
    with pytest.raises(ValueError, match="multiples of 4"):
        bb._check(torch.zeros(1, 4, 4, 8),
                  {"a": torch.zeros(1, 1, 8, 2), "c": torch.zeros(1, 1, 2, 8)},
                  (1, 1), True)


@pytest.mark.parametrize("train,project,int8", [(True, True, False),
                                                (True, False, False),
                                                (False, True, True)])
def test_kernel_sequence_passes_each_c_entry_its_signature(monkeypatch, train,
                                                           project, int8):
    # Without a card: record the C calls the wrapper would make, and check
    # each against the ctypes signature (a wrong count or a pointer where
    # an int belongs would only fail on the card) and the launch plan.
    from deeplearning4j_tpu_torch.kernels import _build

    calls = []

    def fake_launch(name, *args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig), (name, len(args), len(sig))
        for a, t in zip(args, sig):
            if t is _build._I:
                assert isinstance(a, int), (name, a)
            elif t in (_build._F, _build._D):
                assert isinstance(a, float), (name, a)
            else:
                assert a is None or isinstance(a, int), (name, a)
        calls.append(name)

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.no_grad())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    x, params, state = _arrays(27, h=8, filters=4, project=project)
    names = ("a", "b", "c") + (("proj",) if project else ())
    if int8:
        params = _quantize(params, names)
    t = {k: torch.tensor(a, dtype=torch.int8 if a.dtype == np.int8
                         else torch.float32) for k, a in params.items()}
    flat = [t[f"{k}_{n}"] for n in names for k in ("W", "gamma", "beta")]
    scales = {n: t[f"W_{n}__scale"] for n in names} if int8 else None
    running = {k: torch.tensor(a, dtype=torch.float32)
               for k, a in state.items()}
    before = kernels.launches["bottleneck_train" if train
                              else "bottleneck_infer"].value
    y, stats = bb._kernel_block(torch.tensor(x, dtype=torch.float32), flat,
                                scales, None if train else running,
                                (2, 2) if project else (1, 1), 1e-5, "relu",
                                train)
    convs = 4 if project else 3
    assert calls == (["dl4j_bottleneck_conv", "dl4j_bottleneck_stats"]
                     * convs if train else ["dl4j_bottleneck_conv"] * convs) \
        + ["dl4j_bottleneck_tail"]
    assert kernels.launches["bottleneck_train" if train
                            else "bottleneck_infer"].value == before + 1
    assert len(stats) == 2 * convs if train else stats is None
