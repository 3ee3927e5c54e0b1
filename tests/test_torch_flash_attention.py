"""Port attention kernels (CPU: their plain versions) against the JAX
package: `flash_attention` against the Pallas flash kernel in interpret
mode and against `dense_attention`; `paged_decode_attention` against the
Pallas paged kernel in interpret mode; the dense decode-step attention
against `_cached_decode_attention`. f32 at 1e-5; inputs from one numpy
RandomState handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu.nn.layers.attention import _cached_decode_attention
from deeplearning4j_tpu.parallel.sequence import dense_attention
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a):
    return jnp.asarray(a, jnp.float32), torch.tensor(a, dtype=torch.float32)


@pytest.mark.parametrize("t", [16, 32])
def test_flash_matches_jax_pallas_kernel(t):
    rng = np.random.RandomState(6)
    (jq, q), (jk, k), (jv, v) = (_both(rng.randn(2, t, 2, 8))
                                 for _ in range(3))
    # block 8: T is a block multiple, so the Pallas kernel (interpret
    # mode) runs rather than the dense fallback.
    want = jax_fa._flash_attention_pallas(jq, jk, jv, True, None, 8, 8)
    got = fa.flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_dense_at_ragged_t(causal):
    rng = np.random.RandomState(7)
    (jq, q), (jk, k), (jv, v) = (_both(rng.randn(2, 13, 3, 8))
                                 for _ in range(3))
    want = dense_attention(jq, jk, jv, causal=causal, scale=0.3)
    got = fa.flash_attention(q, k, v, causal=causal, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_paged_matches_jax_pallas_kernel(monkeypatch, t, causal):
    # tests/test_kernels.py geometry: a pad tail, zero-page rows, an empty
    # slot, and a multi-token (speculative verify) query width.
    monkeypatch.setenv("DL4J_TPU_KERNEL_FLASH_ATTENTION_PAGED", "pallas")
    registry.clear_cache()
    rng = np.random.RandomState(9)
    B, H, D, page, P = 3, 2, 8, 4, 7
    jq, q = _both(rng.randn(B, t, H, D))
    jkp, kp = _both(rng.randn(P, page, H, D))
    jvp, vp = _both(rng.randn(P, page, H, D))
    table = np.asarray([[1, 2, 3, 0], [4, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([9, 2, 0], np.int32)
    want = jax_fa.paged_decode_attention(jq, jkp, jvp, jnp.asarray(table),
                                         jnp.asarray(pos), causal)
    kernels.reset_counts()
    got = fa.paged_decode_attention(q, kp, vp, torch.tensor(table),
                                    torch.tensor(pos), causal)
    assert kernels.counts()["plain_calls"]["paged_decode_attention"] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("vector_pos", [False, True])
def test_cached_decode_attention_matches_jax(vector_pos):
    rng = np.random.RandomState(10)
    jq, q = _both(rng.randn(2, 2, 2, 8))
    jk, k = _both(rng.randn(2, 12, 2, 8))
    jv, v = _both(rng.randn(2, 12, 2, 8))
    pos = np.asarray([5, 9], np.int32) if vector_pos else 6
    want = _cached_decode_attention(jq, jk, jv, jnp.asarray(pos), True)
    got = fa.cached_decode_attention(
        q, k, v, torch.tensor(pos) if vector_pos else pos, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_other_devices_raise():
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.flash_attention(q, q, q)
    table = torch.empty(1, 2, dtype=torch.int32, device="meta")
    pos = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fa.paged_decode_attention(q[:, :1], q, q, table, pos, True)
