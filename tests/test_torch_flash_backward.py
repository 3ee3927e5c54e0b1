"""The port's training attention (CPU: the plain versions behind
`FlashAttentionFn`) against the JAX package's custom_vjp
`_flash_attention_pallas`, whose forward-with-lse and dq/dkv backward run
as Pallas kernels in interpret mode at 64-row blocks.

Inputs and the output cotangent come from one numpy RandomState and go to
both packages. Tolerances: f32 rtol 2e-4, atol 2e-5 (the JAX package's own
flash tests); bf16 rtol = atol = 4e-2 (bf16 rounds at other places in the
two frameworks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

TOLS = {"float32": dict(rtol=2e-4, atol=2e-5),
        "bfloat16": dict(rtol=4e-2, atol=4e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape) for _ in range(4)]  # q, k, v, cotangent
    jd = jnp.dtype(dtype)
    jax_in = [jnp.asarray(a, jd) for a in arrs]
    torch_in = [torch.tensor(a, dtype=TORCH[dtype]) for a in arrs]
    return jax_in, torch_in


def _as_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype,t,causal", [
    ("float32", 128, True), ("float32", 128, False),
    ("float32", 256, True), ("float32", 256, False),
    ("bfloat16", 128, True),
])
def test_gradients_match_jax_pallas_backward(dtype, t, causal):
    (jq, jk, jv, jg), (q, k, v, g) = _inputs((2, t, 2, 16), dtype, seed=t)

    def loss(q_, k_, v_):
        o = jax_fa._flash_attention_pallas(q_, k_, v_, causal, None, 64, 64)
        return jnp.sum(o.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    for a in (q, k, v):
        a.requires_grad_(True)
    kernels.reset_counts()
    o = fa.flash_attention(q, k, v, causal=causal)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(o, (q, k, v), g)
    plain = kernels.counts()["plain_calls"]
    assert (plain["flash_attention_fwd_lse"], plain["flash_attention_bwd_dq"],
            plain["flash_attention_bwd_dkv"], plain["flash_attention"]) \
        == (1, 1, 1, 0)
    for name, gt, wt in zip("qkv", got, want):
        assert gt.dtype == TORCH[dtype], name
        np.testing.assert_allclose(gt.float().numpy(), _as_np(wt),
                                   err_msg=f"d{name}", **TOLS[dtype])
    # The forward value is the plain flash forward's.
    np.testing.assert_allclose(
        o.detach().float().numpy(),
        _as_np(jax_fa._flash_attention_pallas(jq, jk, jv, causal, None, 64,
                                              64)), **TOLS[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_jax_lse_kernel(causal):
    b, t, h, d = 2, 128, 3, 8
    (jq, jk, jv, _), (q, k, v, _) = _inputs((b, t, h, d), "float32", seed=3)
    to_bhtd = lambda a: jnp.swapaxes(a, 1, 2).reshape(b * h, t, d)
    scale = d ** -0.5
    jo, jlse = jax_fa._flash_fwd_lse_bhtd(to_bhtd(jq), to_bhtd(jk),
                                          to_bhtd(jv), causal, scale, 64, 64)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal, scale)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t),
                               np.asarray(jlse)[..., 0], **TOLS["float32"])
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jnp.swapaxes(jo.reshape(b, h, t, d), 1, 2)),
        **TOLS["float32"])


def test_backward_at_ragged_t_matches_dense_vjp():
    # T = 45 is no block multiple: the JAX package differentiates its dense
    # reference there; the port keeps its recompute-from-lse backward.
    (jq, jk, jv, jg), (q, k, v, g) = _inputs((1, 45, 2, 8), "float32", 11)
    want = jax.vjp(lambda a, b_, c: jax_fa._dense_ref(a, b_, c, True, 0.35),
                   jq, jk, jv)[1](jg)
    for a in (q, k, v):
        a.requires_grad_(True)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, True, 0.35),
                              (q, k, v), g)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   **TOLS["float32"])


def test_inference_keeps_the_plain_forward():
    q = torch.randn(1, 8, 2, 4, requires_grad=True)
    kernels.reset_counts()
    with torch.no_grad():
        o = fa.flash_attention(q, q, q)
    assert o.grad_fn is None
    c = kernels.counts()["plain_calls"]
    assert c["flash_attention"] == 1 and c["flash_attention_fwd_lse"] == 0
