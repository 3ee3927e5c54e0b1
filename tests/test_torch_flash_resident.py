"""The resident flash rows (3: `flash_attention`, 5: `flash_attention_fwd_lse`,
6: `flash_attention_bwd_dq` / `_dkv`) and the rule that picks the form of
their kernels on the card: by dtype and head width alone, one rule for
every flash row (`flash_variant`), the tensor-core form for bf16 at D = 64
or 128. On the CPU the wrappers run their plain versions and count no form;
`FlashAttentionFn` hands the resident backward, as the streamed one, an
aligned copy of a misaligned incoming gradient (the tensor-core form reads
do by TMA). The kernels themselves are held to their plain versions on the
card (`tests/test_torch_cuda_kernels.py`), and the JAX parity of these rows
is in `test_torch_flash_attention.py` and `test_torch_flash_backward.py`.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

RESIDENT = ("flash_attention", "flash_attention_fwd_lse",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def _inputs(b, t, h, d, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    *[(torch.float32, d, "cuda_cores") for d in (16, 24, 32, 64, 96, 128)],
    *[(torch.bfloat16, d, "cuda_cores") for d in (8, 16, 24, 32, 96)],
    *[(torch.float64, d, "f64") for d in (16, 64, 128)]])
def test_resident_variant_by_dtype_and_width(dtype, d, want):
    assert fa.resident_variant(dtype, d) == want
    # One rule for every flash row: the streamed rows' too.
    assert fa.stream_fwd_variant(dtype, d) == fa.stream_bwd_variant(
        dtype, d) == want


def test_every_flash_row_counts_its_forms():
    forms = kernels.counts()["variants"]
    for name in (*RESIDENT, "flash_attention_stream",
                 "flash_attention_bwd_dq_stream",
                 "flash_attention_bwd_dkv_stream"):
        assert set(forms[name]) == {"wgmma", "cuda_cores", "f64"}
    # The paged decode has one form besides its first: float64.
    assert set(forms["paged_decode_attention"]) == {"f64"}


@pytest.mark.parametrize("t", [1, 40, 64, 65])
def test_cpu_tensors_take_no_variant_of_the_resident_kernels(t):
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(2, t, 2, 64, seed=21))
    kernels.reset_counts()
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
    c = kernels.counts()
    assert [c["plain_calls"][n] for n in RESIDENT] == [1, 1, 1, 1]
    assert not any(c["launches"].values())
    for name in RESIDENT:
        assert c["variants"][name] == {"wgmma": 0, "cuda_cores": 0, "f64": 0}
    assert dq.shape == dk.shape == dv.shape == q.shape


@pytest.mark.parametrize("offset,copied", [(0, False), (1, True),
                                           (8, False)])
def test_flash_attention_fn_copies_only_a_misaligned_do_when_resident(
        monkeypatch, offset, copied):
    # The resident backward's tensor-core form refuses a `do` that is not
    # 16-byte aligned, as the streamed one does: FlashAttentionFn hands it
    # an aligned one, copying only when the incoming gradient sits at an
    # odd address (a bf16 view one element in: 2 bytes off; eight elements
    # in: 16 bytes, aligned).
    shape = (2, 64, 2, 64)
    q, k, v = (torch.tensor(a).bfloat16().requires_grad_(True)
               for a in _inputs(*shape, seed=22, n=3))
    assert not fa.streamed(q)
    buf = torch.tensor(_inputs(1, 1, 1, int(np.prod(shape)) + offset,
                               seed=23, n=1)[0].ravel()).bfloat16()
    g = buf[offset:].view(shape)
    assert g.is_contiguous() and (g.data_ptr() % 16 == 0) != copied
    seen = []
    real = fa.flash_attention_bwd

    def spy(q_, k_, v_, o_, lse_, do_, causal, scale):
        seen.append(do_)
        return real(q_, k_, v_, o_, lse_, do_, causal, scale)

    monkeypatch.setattr(fa, "flash_attention_bwd", spy)
    kernels.reset_counts()
    got = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v), g)
    do, = seen
    assert do.data_ptr() % 16 == 0 and do.is_contiguous()
    assert (do.data_ptr() != g.data_ptr()) == copied
    assert torch.equal(do, g)
    plain = kernels.counts()["plain_calls"]
    assert [plain[n] for n in RESIDENT] == [0, 1, 1, 1]
    want = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                               g.clone())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
