"""Port `layernorm_norm_act` (CPU: its plain version) against the JAX
package's `layernorm_norm_act` running its Pallas kernel in interpret mode,
at any width; and, without a card, the kernel wrapper handing every width
to its C entry.

Inputs come from one numpy RandomState and go to both packages. Tolerances
as the JAX package's own parity matrix (tests/test_kernels.py): f32 1e-5,
bf16 4e-2 (bf16 rounds its intermediates at other places in the two
frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import norm_act as jax_norm_act
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import norm_act

TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=4e-2, atol=4e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(monkeypatch, shape, dtype, act, seed=5):
    monkeypatch.setenv("DL4J_TPU_KERNEL_NORM_ACT", "pallas")
    registry.clear_cache()
    rng = np.random.RandomState(seed)
    feats = shape[-1]
    x = rng.randn(*shape) * 2 + 0.5
    g = rng.rand(feats) + 0.5
    b = rng.randn(feats)
    jd = jnp.dtype(dtype)
    want = jax_norm_act.layernorm_norm_act(
        jnp.asarray(x, jd), jnp.asarray(g, jd), jnp.asarray(b, jd), 1e-5, act)
    td = TORCH[dtype]
    got = norm_act.layernorm_norm_act(
        torch.tensor(x, dtype=td), torch.tensor(g, dtype=td),
        torch.tensor(b, dtype=td), 1e-5, act)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "sigmoid"])
def test_layernorm_matches_jax_kernel_unaligned(monkeypatch, dtype, act):
    # 6 rows x 10 features: neither a sublane nor a lane multiple.
    got, want = _pair(monkeypatch, (6, 10), dtype, act)
    assert got.dtype == TORCH[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 128), (2, 3, 24)])
def test_layernorm_matches_jax_kernel_shapes(monkeypatch, dtype, shape):
    got, want = _pair(monkeypatch, shape, dtype, "identity", seed=6)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOLS[dtype])


def test_cpu_tensor_takes_the_plain_version_only():
    kernels.reset_counts()
    x = torch.randn(3, 8)
    norm_act.layernorm_norm_act(x, torch.ones(8), torch.zeros(8), 1e-5, "relu")
    c = kernels.counts()
    assert c["plain_calls"]["layernorm_norm_act"] == 1
    assert c["launches"]["layernorm_norm_act"] == 0


def test_other_devices_raise():
    x = torch.empty(3, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        norm_act.layernorm_norm_act(x, x[0], x[0], 1e-5, "identity")
    with pytest.raises(ValueError, match="different devices"):
        norm_act.layernorm_norm_act(torch.zeros(3, 8), x[0], x[0], 1e-5,
                                    "identity")


WIDE = [100, 520, 4096, 8192]  # widths past the warp's reach, or ragged


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("feats", WIDE)
def test_layernorm_matches_jax_kernel_at_any_width(monkeypatch, dtype,
                                                   feats):
    got, want = _pair(monkeypatch, (3, feats), dtype, "relu", seed=7)
    np.testing.assert_allclose(got.float().numpy(), want, **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("feats", WIDE)
def test_kernel_wrapper_hands_any_width_to_the_c_entry(monkeypatch, dtype,
                                                       feats):
    # Without a card: the wrapper refuses no width (the C entry picks the
    # kernel's form) and hands it the inputs' own pointers.
    from deeplearning4j_tpu_torch.kernels import _build

    calls = []

    def fake_launch(name, *args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig)
        for a, t in zip(args, sig):
            assert isinstance(a, float if t is _build._F else int), (name, a)
        calls.append((name, args))

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(_build, "on_device", lambda i: torch.no_grad())
    monkeypatch.setattr(_build, "current_stream", lambda i: 0)
    x = torch.zeros(5, feats, dtype=dtype)
    g, b = torch.ones(feats, dtype=dtype), torch.zeros(feats, dtype=dtype)
    before = kernels.launches["layernorm_norm_act"].value
    norm_act.layernorm_norm_act(x, g, b, 1e-5, "tanh")
    assert kernels.launches["layernorm_norm_act"].value == before + 1
    ((name, args),) = calls
    assert name == "dl4j_layernorm_norm_act"
    assert args[:3] == (x.data_ptr(), g.data_ptr(), b.data_ptr())
    assert args[4:6] == (5, feats)
    assert args[7:9] == (2, norm_act.DTYPE_CODES[dtype])
