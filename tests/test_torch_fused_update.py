"""The port's training numerics against the JAX package, on the CPU.

- `kernels.fused_update.dispatch` (CPU: the plain versions) against JAX
  `fused_update.dispatch`, both through its Pallas kernel in interpret mode
  (`DL4J_TPU_KERNEL_FUSED_UPDATE=pallas`) and through its XLA bodies
  (`=xla`), for adam/nesterovs/rmsprop at steps 0 and 2 over leaves whose
  sizes are no multiple of 1024;
- `ops/updaters.create` for all eight updaters, `ops/schedules` for every
  policy, `ops/grad_norm` for every mode, `nn/losses.score` for sparse and
  dense labels;
- LayerNorm gradients (`LayerNormFn`) against `jax.grad` through
  `layernorm_norm_act` with its Pallas forward forced;
- the scalars `apply_step` hands the kernel's C entry (the launch faked),
  f32 for the f32 form and doubles for the float64 form.

Inputs come from numpy RandomStates and go to both packages. Tolerances:
updates rtol 1e-5, atol 1e-6 (tests/test_kernels.py's; an FMA or a pow may
move an f32 ulp); schedules 1e-6 relative; losses and f32 LayerNorm
gradients rtol 2e-5, atol 1e-5; bf16 4e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import fused_update as jax_fused
from deeplearning4j_tpu.kernels import norm_act as jax_norm_act
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.ops import grad_norm as jax_grad_norm
from deeplearning4j_tpu.ops import schedules as jax_schedules
from deeplearning4j_tpu.ops import updaters as jax_updaters
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import fused_update, norm_act
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.ops import grad_norm, schedules, updaters

UPD = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"W": (33, 7), "b": (5,), "gamma": (1025,)}
HYPER = {"adam": (0.9, 0.999, 1e-8), "nesterovs": (0.9,),
         "rmsprop": (0.95, 1e-8)}


def _tree(rng, scale=1.0, positive=False):
    out = {}
    for k, s in SHAPES.items():
        a = rng.randn(*s) * scale
        out[k] = np.abs(a) if positive else a
    return {k: a.astype(np.float32) for k, a in out.items()}


def _state(kind, rng):
    if kind == "adam":
        return {"m": _tree(rng, 0.1), "v": _tree(rng, 0.01, positive=True)}
    if kind == "nesterovs":
        return {"v": _tree(rng, 0.1)}
    return {"g2": _tree(rng, 0.01, positive=True)}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.tensor, tree)


def _check(got, want, **tol):
    flat_g = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), got))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["adam", "nesterovs", "rmsprop"])
@pytest.mark.parametrize("step", [0, 2])
def test_dispatch_matches_jax(monkeypatch, impl, kind, step):
    monkeypatch.setenv("DL4J_TPU_KERNEL_FUSED_UPDATE", impl)
    registry.clear_cache()
    rng = np.random.RandomState(step + 10 * len(kind))
    state, grads = _state(kind, rng), _tree(rng)
    lr = 3e-3
    want_state, want_d = jax_fused.dispatch(
        kind, _to_jax(state), _to_jax(grads), jnp.float32(lr),
        jnp.float32(step), HYPER[kind])
    kernels.reset_counts()
    got_state, got_d = fused_update.dispatch(
        kind, _to_torch(state), _to_torch(grads), lr, step, HYPER[kind])
    assert kernels.counts()["plain_calls"]["fused_update"] == 1
    _check(got_state, want_state, **UPD)
    _check(got_d, want_d, **UPD)


@pytest.mark.parametrize("name", updaters.UPDATERS)
def test_updaters_create_matches_jax(name):
    rng = np.random.RandomState(len(name))
    params = _tree(rng)
    hyper = dict(momentum=0.8, adam_mean_decay=0.85, adam_var_decay=0.99,
                 rho=0.9, rms_decay=0.9, epsilon=None)
    ju = jax_updaters.create(name, **hyper)
    pu = updaters.create(name, **hyper)
    js, ps = ju.init(_to_jax(params)), pu.init(_to_torch(params))
    if js == ():
        js = {}
    for step in range(3):
        g = _tree(rng)
        js, jd = ju.update(js, _to_jax(g), jnp.float32(0.01),
                           jnp.float32(step))
        ps, pd = pu.update(ps, _to_torch(g), 0.01, step)
        _check(pd, jd, **UPD)
        _check(ps, {} if js == () else js, **UPD)


@pytest.mark.parametrize("policy", schedules.POLICIES)
def test_schedules_match_jax(policy):
    args = dict(decay_rate=0.7, power=1.5, steps=3.0, max_iterations=20,
                schedule_map={2: 0.05, 9: 0.01})
    jf = jax_schedules.make_schedule(0.1, policy, **args)
    pf = schedules.make_schedule(0.1, policy, **args)
    for it in (0, 1, 2, 5, 9, 17, 25):
        want = float(jf(jnp.float32(it)))
        np.testing.assert_allclose(pf(it), want, rtol=1e-6, err_msg=str(it))


@pytest.mark.parametrize("mode", grad_norm.MODES)
def test_grad_norm_matches_jax(mode):
    g = _tree(np.random.RandomState(4), scale=0.3)
    want = jax_grad_norm.normalize_layer_gradients(_to_jax(g), mode, 0.5)
    got = grad_norm.normalize_layer_gradients(_to_torch(g), mode, 0.5)
    _check(got, want, rtol=2e-5, atol=1e-6)


_DENSE_CASES = [
    ("mcxent", "softmax"), ("mcxent", "sigmoid"),
    ("negativeloglikelihood", "softmax"), ("xent", "sigmoid"),
    ("xent", "tanh"), ("reconstruction_crossentropy", "sigmoid"),
    ("mse", "identity"), ("squared_loss", "tanh"), ("l2", "identity"),
    ("l1", "identity"), ("mean_absolute_error", "relu"),
    ("mean_absolute_percentage_error", "identity"),
    ("mean_squared_logarithmic_error", "relu"),
    ("cosine_proximity", "identity"), ("hinge", "identity"),
    ("squared_hinge", "tanh"), ("kl_divergence", "softmax"),
    ("poisson", "relu"), ("rmse_xent", "sigmoid"),
]


@pytest.mark.parametrize("loss,act", _DENSE_CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_score_dense_labels_matches_jax(loss, act, masked):
    rng = np.random.RandomState(len(loss) + len(act))
    preout = rng.randn(3, 5, 6).astype(np.float32)
    if loss in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        labels = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (3, 5))]
    elif loss in ("xent", "reconstruction_crossentropy", "rmse_xent"):
        labels = (rng.rand(3, 5, 6) > 0.5).astype(np.float32)
    elif loss in ("hinge", "squared_hinge"):
        labels = np.sign(rng.randn(3, 5, 6)).astype(np.float32)
    else:
        labels = rng.rand(3, 5, 6).astype(np.float32)
    mask = (np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]],
                     np.float32) if masked else None)
    want = jax_losses.score(loss, jnp.asarray(labels), jnp.asarray(preout),
                            act, None if mask is None else jnp.asarray(mask))
    got = losses.score(loss, torch.tensor(labels), torch.tensor(preout), act,
                       None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("loss,act", [("mcxent", "softmax"),
                                      ("negativeloglikelihood", "sigmoid")])
def test_score_sparse_labels_matches_jax(loss, act):
    rng = np.random.RandomState(8)
    preout = rng.randn(2, 7, 11).astype(np.float32) * 3
    ids = rng.randint(0, 11, (2, 7)).astype(np.int32)
    want = jax_losses.score(loss, jnp.asarray(ids), jnp.asarray(preout), act)
    got = losses.score(loss, torch.tensor(ids), torch.tensor(preout), act)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5, atol=1e-5)
    # Summed over time, divided by the batch only.
    per = losses.compute_per_example(loss, torch.tensor(ids),
                                     torch.tensor(preout), act)
    assert tuple(per.shape) == (2, 7)
    np.testing.assert_allclose(float(got), float(per.sum()) / 2, rtol=1e-6)
    with pytest.raises(ValueError, match="class-id"):
        losses.score("mse", torch.tensor(ids), torch.tensor(preout))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["identity", "relu", "tanh"])
def test_layernorm_gradients_match_jax(monkeypatch, dtype, act):
    monkeypatch.setenv("DL4J_TPU_KERNEL_NORM_ACT", "pallas")
    registry.clear_cache()
    rng = np.random.RandomState(12)
    x, g, b, w = (rng.randn(4, 3, 24) * 2 + 0.5, rng.rand(24) + 0.5,
                  rng.randn(24), rng.randn(4, 3, 24))
    jd = jnp.dtype(dtype)
    jw = jnp.asarray(w, jnp.float32)

    def loss(x_, g_, b_):
        y = jax_norm_act.layernorm_norm_act(x_, g_, b_, 1e-5, act)
        return jnp.sum(y.astype(jnp.float32) * jw)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x, jd), jnp.asarray(g, jd), jnp.asarray(b, jd))
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ts = [torch.tensor(a, dtype=td, requires_grad=True) for a in (x, g, b)]
    kernels.reset_counts()
    y = norm_act.layernorm_norm_act(*ts, 1e-5, act)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    got = torch.autograd.grad(y, ts, torch.tensor(w, dtype=td))
    # The backward's recompute is the reference VJP, not a plain call.
    assert kernels.counts()["plain_calls"]["layernorm_norm_act"] == 1
    tol = (dict(rtol=2e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=4e-2, atol=4e-2))
    for name, gt, wt in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(gt.float().numpy(),
                                   np.asarray(jnp.asarray(wt, jnp.float32)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("kind", sorted(HYPER))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_launch_scalars_by_dtype(monkeypatch, kind, dtype):
    # What `apply_step` hands the C entry, read back from its arrays (the
    # launch itself faked): the f32 form gets floats, the float64 form
    # doubles with bc1 and bc2 the f32 values `scalars` computes and the
    # kind's constants unrounded, through the same entry at dtype code 4;
    # both the same lrs.
    import ctypes

    seen = {}

    def launch(name, *args):
        n = args[2]
        ct = ctypes.c_double if args[8] == 4 else ctypes.c_float
        read = lambda p, k: list(ctypes.cast(p, ctypes.POINTER(ct))[:k])  # noqa
        seen.update(name=name, n=n, code=args[8], lrs=read(args[5], n),
                    factors=read(args[6], n), scalars=read(args[7], 8))

    monkeypatch.setattr(fused_update._build, "launch", launch)
    monkeypatch.setattr(fused_update._build, "current_stream", lambda i: 0)
    monkeypatch.setattr(fused_update._build, "on_device",
                        lambda i: __import__("contextlib").nullcontext())
    rng = np.random.RandomState(1)
    grads = {k: torch.tensor(a, dtype=dtype) for k, a in _tree(rng).items()}
    params = {k: torch.zeros_like(g) for k, g in grads.items()}
    state = {f: {k: torch.zeros_like(g) for k, g in grads.items()}
             for f in fused_update.FIELDS[kind]}
    f0 = fused_update.FIELDS[kind][0]
    table = fused_update._pack(fused_update._SUB, [
        (params[k], g, state[f0][k], state["v"][k] if kind == "adam"
         else None, 0.0123, 2.0 if k == "b" else 1.0, k, None)
        for k, g in grads.items()])
    fused_update._run(kind, HYPER[kind], 6, fused_update._SUB, table)
    wide = dtype == torch.float64
    assert seen["name"] == "dl4j_fused_update"
    assert seen["code"] == (4 if wide else 0)
    assert seen["n"] == len(SHAPES)
    assert seen["lrs"] == [float(np.float32(0.0123))] * len(SHAPES)
    assert sorted(seen["factors"]) == [1.0, 1.0, 2.0]
    _, bc1, bc2 = fused_update.scalars(0.0, 6, kind, HYPER[kind])
    want = [float(bc1), float(bc2)]
    if kind == "adam":
        b1, b2, eps = HYPER[kind]
        want += [b1, 1 - b1, b2, 1 - b2, eps]
    elif kind == "nesterovs":
        want += [HYPER[kind][0], 1.0 + HYPER[kind][0]]
    else:
        want += [HYPER[kind][0], 1 - HYPER[kind][0], HYPER[kind][1]]
    want += [0.0] * (8 - len(want))
    if not wide:
        want = [float(np.float32(x)) for x in want]
    assert seen["scalars"] == want
