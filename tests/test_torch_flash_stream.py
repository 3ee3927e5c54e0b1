"""The port's streamed attention (rows 4 and 7: CPU, the plain versions
behind `flash_attention_stream` and the streamed backward) against the JAX
package's streamed Pallas kernels, run directly (`_flash_fwd_stream_bhtd`,
`_flash_bwd_stream_bhtd`, so always streamed, in interpret mode), and the
dispatch that picks them.

Inputs come from one numpy RandomState and go to both packages; the JAX
kernels take [BH, T, D] with lse [BH, T, 1], the port [B, T, H, D] with lse
[B, H, T]. Tolerances: the forward rtol 2e-5, atol 2e-6 (the same f32
softmax, sums in another order); the backward rtol 2e-4, atol 2e-5, the
JAX package's own flash tolerances.

The CUDA kernels split the list into units and merge their partials in
log-sum-exp form; `_emulate_units` below replays that schedule with torch
ops, so the unit cut and the merge weights are held here too (the kernels
themselves are held to the plain versions on the card,
`tests/test_torch_cuda_kernels.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.parallel import sequence

FWD = dict(rtol=2e-5, atol=2e-6)
BWD = dict(rtol=2e-4, atol=2e-5)
STREAM = ("flash_attention_stream", "flash_attention_bwd_dq_stream",
          "flash_attention_bwd_dkv_stream")
RESIDENT = ("flash_attention", "flash_attention_fwd_lse",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def _inputs(b, t, h, d, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(n)]


def _bhtd(a):
    b, t, h, d = a.shape
    return jnp.asarray(np.swapaxes(a, 1, 2).reshape(b * h, t, d))


def _from_bhtd(a, b, h):
    bh, t, d = a.shape
    return np.swapaxes(np.asarray(a).reshape(b, h, t, d), 1, 2)


@pytest.mark.parametrize("nq,nk,bq,bk", [(5, 5, 64, 64), (4, 8, 128, 64),
                                         (8, 4, 64, 128), (1, 1, 256, 256),
                                         (3, 3, 256, 256), (7, 2, 32, 96)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("order", ["row", "col"])
def test_pair_arrays_equal_jax(nq, nk, bq, bk, causal, order):
    got = fa.pair_arrays(nq, nk, bq, bk, causal, order)
    want = jax_fa._pair_arrays(nq, nk, bq, bk, causal, order)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("t", [1, 64, 300, 4096])
@pytest.mark.parametrize("pairs", ["triangle", "rectangle"])
@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("unit_tiles", [1, 3, 64])
def test_schedule_covers_every_pair_once(t, pairs, order, unit_tiles):
    sch = fa.stream_schedule(t, pairs == "triangle", order, unit_tiles)
    n = -(-t // 64)
    want = set(zip(*fa.pair_arrays(n, n, 64, 64, pairs == "triangle",
                                   order)))
    seen, slots = [], []
    outer = sch.pairs[0] if order == "row" else sch.pairs[1]
    for first, count, slot in sch.units.tolist():
        assert 1 <= count <= unit_tiles
        run = outer[first:first + count]
        assert (run == run[0]).all(), "a unit crosses runs"
        seen += list(zip(*sch.pairs[:, first:first + count].tolist()))
        if slot >= 0:
            slots.append(slot)
    assert sorted(seen) == sorted(want) and len(seen) == len(want)
    assert sorted(slots) == list(range(sch.n_slots))
    counts = sch.units[:, 1]
    assert (np.diff(counts) <= 0).all(), "units are not longest first"
    # Each merge names its run's slots, consecutive, and its outer tile.
    for tile, slot0, nslots in sch.merges.tolist():
        units = sch.units[(sch.units[:, 2] >= slot0)
                          & (sch.units[:, 2] < slot0 + nslots)]
        assert len(units) == nslots > 1
        assert (outer[units[:, 0]] == tile).all()
        sizes = units[:, 1]
        assert sizes.max() - sizes.min() <= 1, "units of a run are unequal"


def test_schedule_at_the_slice_shape():
    sch = fa.stream_schedule(32768, True, "row", fa._UNIT_TILES)
    assert len(sch.pairs[0]) == 512 * 513 // 2
    assert sch.units[:, 1].max() == 64 and len(sch.units) == 2304
    ws = fa.stream_workspace_bytes(1, 32768, 8, 64)
    assert ws == {"forward": 2240 * 8 * 64 * 4 * 66,
                  "dq": 2240 * 8 * 64 * 4 * 64,
                  "dkv": 2 * 2240 * 8 * 64 * 4 * 64}


@pytest.mark.parametrize("causal", [True, False])
def test_stream_forward_matches_jax_stream_kernel(causal):
    b, t, h, d = 1, 320, 2, 16
    q, k, v = _inputs(b, t, h, d, seed=1, n=3)
    scale = d ** -0.5
    jo, jlse = jax_fa._flash_fwd_stream_bhtd(_bhtd(q), _bhtd(k), _bhtd(v),
                                             causal, scale, 64, 64)
    kernels.reset_counts()
    o, lse = fa.flash_attention_stream(*map(torch.tensor, (q, k, v)),
                                       causal, scale)
    assert kernels.counts()["plain_calls"]["flash_attention_stream"] == 1
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, t)
    np.testing.assert_allclose(o.numpy(), _from_bhtd(jo, b, h), **FWD)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t),
                               np.asarray(jlse)[..., 0], **FWD)


@pytest.mark.parametrize("causal", [True, False])
def test_stream_backward_matches_jax_stream_kernels(causal):
    b, t, h, d = 1, 320, 2, 16
    q, k, v, do = _inputs(b, t, h, d, seed=2)
    scale = d ** -0.5
    jo, jlse = jax_fa._flash_fwd_stream_bhtd(_bhtd(q), _bhtd(k), _bhtd(v),
                                             causal, scale, 64, 64)
    want = jax_fa._flash_bwd_stream_bhtd(_bhtd(q), _bhtd(k), _bhtd(v),
                                         _bhtd(do), jo, jlse, causal, scale,
                                         64, 64)
    tq, tk, tv, tdo = map(torch.tensor, (q, k, v, do))
    o, lse = fa.flash_attention_stream(tq, tk, tv, causal, scale)
    kernels.reset_counts()
    got = fa.flash_attention_bwd_stream(tq, tk, tv, o, lse, tdo, causal,
                                        scale)
    plain = kernels.counts()["plain_calls"]
    assert [plain[n] for n in STREAM] == [0, 1, 1]
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), _from_bhtd(w, b, h),
                                   err_msg=f"d{name}", **BWD)


def _emulate_units(q, k, v, causal, scale, pairs, unit_tiles):
    """The CUDA forward's schedule replayed with torch ops: each unit's
    online-softmax partial (acc, m, l) over its tiles, written out for a
    run of one unit, else merged as the merge kernel merges them."""
    b, t, h, d = q.shape
    qt, kt, vt = (a.transpose(1, 2).double() for a in (q, k, v))
    sch = fa.stream_schedule(t, pairs == "triangle", "row", unit_tiles)
    o = torch.zeros_like(qt)
    lse = torch.zeros(b, h, t, dtype=torch.float64)
    parts = {}
    for first, count, slot in sch.units.tolist():
        r0 = int(sch.pairs[0, first]) * 64
        rows = slice(r0, min(r0 + 64, t))
        qpos = torch.arange(r0, min(r0 + 64, t))
        m = torch.full((b, h, len(qpos)), fa._NEG, dtype=torch.float64)
        acc, l_ = torch.zeros(b, h, len(qpos), d, dtype=torch.float64), 0
        for p in range(first, first + count):
            c0 = int(sch.pairs[1, p]) * 64
            kpos = torch.arange(c0, min(c0 + 64, t))
            s = torch.einsum("bhqd,bhkd->bhqk", qt[:, :, rows],
                             kt[:, :, c0:c0 + 64]) * scale
            if causal:
                s = s.masked_fill(kpos[None, :] > qpos[:, None], fa._NEG)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            pw = torch.exp(s - m_new[..., None])
            l_ = l_ * corr + pw.sum(-1)
            acc = acc * corr[..., None] + pw @ vt[:, :, c0:c0 + 64]
            m = m_new
        if slot < 0:
            o[:, :, rows] = acc / l_[..., None]
            lse[:, :, rows] = m + torch.log(l_)
        else:
            parts[slot] = (rows, acc, m, l_)
    weights = []
    for tile, slot0, n in sch.merges.tolist():
        rows = parts[slot0][0]
        mx = torch.stack([parts[slot0 + s][2] for s in range(n)]).amax(0)
        w = [torch.exp(parts[slot0 + s][2] - mx) for s in range(n)]
        weights += w
        big_l = sum(wi * parts[slot0 + s][3] for s, wi in enumerate(w))
        acc = sum(wi[..., None] * parts[slot0 + s][1]
                  for s, wi in enumerate(w))
        o[:, :, rows] = acc / big_l[..., None]
        lse[:, :, rows] = mx + torch.log(big_l)
    return o.transpose(1, 2), lse, parts, weights


@pytest.mark.parametrize("t", [300, 256])
def test_rectangle_list_gives_the_triangle(t):
    q, k, v = map(torch.tensor, _inputs(2, t, 2, 8, seed=3, n=3))
    tri, tri_lse = fa.flash_attention_stream(q, k, v, True, 0.3)
    rect, rect_lse = fa.flash_attention_stream(q, k, v, True, 0.3,
                                               pairs="rectangle")
    np.testing.assert_array_equal(rect.numpy(), tri.numpy())
    np.testing.assert_array_equal(rect_lse.numpy(), tri_lse.numpy())
    # The units' schedule: with the rectangular list cut into units of one
    # tile, whole units lie above the diagonal; they end at m = -1e30 and
    # the merge weighs them exactly 0.
    for pairs in ("triangle", "rectangle"):
        o, lse, parts, weights = _emulate_units(q, k, v, True, 0.3, pairs,
                                                unit_tiles=1)
        np.testing.assert_allclose(o.numpy(), tri.numpy(), **FWD)
        np.testing.assert_allclose(lse.numpy(), tri_lse.numpy(), **FWD)
        above = [s for s, (_, _, m, _) in parts.items()
                 if bool((m == fa._NEG).all())]
        assert bool(above) == (pairs == "rectangle")
    zero = [w for w in weights if bool((w == 0).all())]
    assert len(zero) == len(above) > 0


def test_units_reproduce_the_plain_forward_without_mask():
    q, k, v = map(torch.tensor, _inputs(1, 200, 3, 8, seed=4, n=3))
    want, want_lse = fa.flash_attention_stream(q, k, v, False, 0.4)
    o, lse, _, _ = _emulate_units(q, k, v, False, 0.4, "rectangle", 2)
    np.testing.assert_allclose(o.numpy(), want.numpy(), **FWD)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **FWD)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    *[(torch.float32, d, "cuda_cores") for d in (16, 24, 32, 64, 96, 128)],
    *[(torch.bfloat16, d, "cuda_cores") for d in (16, 24, 32, 96)]])
def test_stream_fwd_variant_by_dtype_and_width(dtype, d, want):
    assert fa.stream_fwd_variant(dtype, d) == want


def test_cpu_tensors_take_no_variant_of_the_kernel():
    q, k, v = (torch.tensor(a).bfloat16()
               for a in _inputs(1, 70, 2, 64, seed=6, n=3))
    kernels.reset_counts()
    fa.flash_attention_stream(q, k, v, True)
    c = kernels.counts()
    assert c["plain_calls"]["flash_attention_stream"] == 1
    assert c["launches"]["flash_attention_stream"] == 0
    assert c["variants"]["flash_attention_stream"] == {"wgmma": 0,
                                                       "cuda_cores": 0}


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    *[(torch.float32, d, "cuda_cores") for d in (16, 24, 32, 64, 96, 128)],
    *[(torch.bfloat16, d, "cuda_cores") for d in (16, 24, 32, 96)]])
def test_stream_bwd_variant_by_dtype_and_width(dtype, d, want):
    assert fa.stream_bwd_variant(dtype, d) == want


def test_cpu_tensors_take_no_variant_of_the_backward_kernels():
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(1, 70, 2, 64, seed=8))
    o, lse = fa.flash_attention_stream(q, k, v, True)
    kernels.reset_counts()
    fa.flash_attention_bwd_stream(q, k, v, o, lse, do, True)
    c = kernels.counts()
    assert [c["plain_calls"][n] for n in STREAM] == [0, 1, 1]
    assert not any(c["launches"].values())
    for name in STREAM[1:]:
        assert c["variants"][name] == {"wgmma": 0, "cuda_cores": 0}


def bf16_operand_row_errors(t=4096, h=2, d=64, seed=11, b=1):
    """The largest row error of dq, dk and dv that the tensor-core
    backward's rounding alone gives: p and ds rounded to bf16 before the
    products ds k, p^T do and ds^T q (f32 sums), the outputs to bf16, held
    as the card checks hold them (each row over max(||row||, 0.1 x the
    median row norm), dq from row 1) against the plain f32 formulas rounded
    to bf16. One
    causal [b, t, h, d] case from bf16 inputs, lse and D from the plain
    forward."""
    q, k, v, do = (torch.tensor(a).bfloat16()
                   for a in _inputs(b, t, h, d, seed))
    scale = d ** -0.5
    o, lse = fa.flash_stream_fwd_plain(q, k, v, True, scale)
    drow = fa._drow(o, do)
    q_, k_, v_, do_ = fa._bhtd(q, k, v, do)

    def rb(x):
        return x.bfloat16().float()

    out = {n: [torch.zeros_like(q_), torch.zeros_like(q_)]
           for n in ("dq", "dk", "dv")}
    for r0, r1, c0, c1 in fa._spans(t, True, "row"):
        p, ds = fa._stream_bwd_terms(q_, k_, v_, do_, lse, drow, r0, r1,
                                     c0, c1, True, scale)
        for i, f in enumerate((lambda x: x, rb)):
            out["dq"][i][:, :, r0:r1] = f(ds) @ k_[:, :, c0:c1] * scale
            out["dk"][i][:, :, c0:c1] += \
                f(ds).transpose(-1, -2) @ q_[:, :, r0:r1] * scale
            out["dv"][i][:, :, c0:c1] += \
                f(p).transpose(-1, -2) @ do_[:, :, r0:r1]
    errors = {}
    for name, (want, got) in out.items():
        # dq's row 0 is 0 in exact arithmetic: held elementwise only.
        rows = slice(1 if name == "dq" else 0, None)
        want, got = rb(want[:, :, rows]), rb(got[:, :, rows])
        norm = want.norm(dim=-1)
        norm = norm.clamp(min=0.1 * float(norm.median()))
        errors[name] = float(((got - want).norm(dim=-1) / norm).max())
    return errors


def test_bf16_operand_rounding_stays_under_half_the_row_limit():
    # The card checks hold row 7's bf16 dq, dk and dv row by row within
    # 1.2e-2 (chip_smoke.py BWD_ROW_TOL, tests/test_torch_cuda_kernels.py):
    # about twice what the tensor-core form's rounding gives, so a fault of
    # a few percent of a row shows while the rounding passes.
    errors = bf16_operand_row_errors()
    assert all(1e-3 < e < 6e-3 for e in errors.values()), errors


def test_bf16_operand_rounding_at_the_resident_shape():
    # The resident row 6 runs the same tensor-core tiles over one block per
    # whole row or column (the training step: B = 16, T = 1024): at B = 2,
    # T = 1024 their rounding, too, stays under half of the 1.2e-2 limit
    # the card checks hold its dq, dk and dv to.
    errors = bf16_operand_row_errors(t=1024, h=2, d=64, b=2)
    assert all(1e-3 < e < 6e-3 for e in errors.values()), errors


@pytest.mark.parametrize("offset,copied", [(0, False), (1, True),
                                           (8, False)])
def test_flash_attention_fn_copies_only_a_misaligned_do(monkeypatch, offset,
                                                        copied):
    # The streamed backward's tensor-core form refuses a `do` that is not
    # 16-byte aligned: FlashAttentionFn hands it an aligned one, copying
    # only when the incoming gradient sits at an odd address (a bf16 view
    # one element in: 2 bytes off; eight elements in: 16 bytes, aligned).
    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    shape = (1, 64, 2, 64)
    q, k, v = (torch.tensor(a).bfloat16().requires_grad_(True)
               for a in _inputs(*shape, seed=9, n=3))
    buf = torch.tensor(_inputs(1, 1, 1, 64 * 64 * 2 + offset, seed=10,
                               n=1)[0].ravel()).bfloat16()
    g = buf[offset:].view(shape)
    assert g.is_contiguous() and (g.data_ptr() % 16 == 0) != copied
    seen = []
    real = fa.flash_attention_bwd_stream

    def spy(q_, k_, v_, o_, lse_, do_, causal, scale):
        seen.append(do_)
        return real(q_, k_, v_, o_, lse_, do_, causal, scale)

    monkeypatch.setattr(fa, "flash_attention_bwd_stream", spy)
    out = fa.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), g)
    do, = seen
    assert do.data_ptr() % 16 == 0 and do.is_contiguous()
    assert (do.data_ptr() != g.data_ptr()) == copied
    assert torch.equal(do, g)
    want = torch.autograd.grad(fa.flash_attention(q, k, v), (q, k, v),
                               g.clone())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,t,itemsize", [
    (torch.float32, 12288, 4), (torch.float32, 12289, 4),
    (torch.bfloat16, 24576, 2), (torch.bfloat16, 24577, 2)])
def test_dispatch_rule_equals_jax(dtype, t, itemsize):
    q = torch.empty((1, t, 8, 64), dtype=dtype, device="meta")
    assert fa._RESIDENT_KV_LIMIT == jax_fa._RESIDENT_KV_LIMIT
    jax_streams = 2 * t * 64 * itemsize > jax_fa._RESIDENT_KV_LIMIT
    assert fa.streamed(q) == jax_streams == (t % 2 == 1)


def test_limit_routes_every_entry_to_the_streamed_rows(monkeypatch):
    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    q, k, v, g = map(torch.tensor, _inputs(1, 96, 2, 8, seed=5))
    kernels.reset_counts()
    with torch.no_grad():
        o = fa.flash_attention(q, k, v)
    plain = kernels.counts()["plain_calls"]
    assert [plain[n] for n in STREAM] == [1, 0, 0]
    assert not any(plain[n] for n in RESIDENT)
    assert isinstance(o, torch.Tensor)
    for a in (q, k, v):
        a.requires_grad_(True)
    kernels.reset_counts()
    out = fa.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.autograd.grad(out, (q, k, v), g)
    plain = kernels.counts()["plain_calls"]
    assert [plain[n] for n in STREAM] == [1, 1, 1]
    assert not any(plain[n] for n in RESIDENT)
    assert not any(kernels.counts()["launches"].values())


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_t_matches_dense_attention(monkeypatch, causal):
    # T = 300 is no multiple of the 64-row tile (nor of JAX's 256 block,
    # where the JAX package would go dense): the streamed rows mask the
    # ragged tile.
    monkeypatch.setattr(fa, "_RESIDENT_KV_LIMIT", 0)
    q, k, v, g = map(torch.tensor, _inputs(2, 300, 2, 8, seed=6))
    want = sequence.dense_attention(q, k, v, causal=causal, scale=0.35)
    for a in (q, k, v):
        a.requires_grad_(True)
    kernels.reset_counts()
    got = fa.flash_attention(q, k, v, causal, 0.35)
    assert kernels.counts()["plain_calls"]["flash_attention_stream"] == 1
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **FWD)
    grads = torch.autograd.grad(got, (q, k, v), g)
    wants = torch.autograd.grad(
        sequence.dense_attention(q, k, v, causal=causal, scale=0.35),
        (q, k, v), g)
    for name, gt, wt in zip("qkv", grads, wants):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(),
                                   err_msg=f"d{name}", **BWD)


@pytest.mark.parametrize("t", [64, 130])
def test_sequence_attention_dense_equals_auto(t):
    q, k, v = map(torch.tensor, _inputs(2, t, 4, 8, seed=7, n=3))
    kernels.reset_counts()
    dense = sequence.attention(q, k, v, causal=True, impl="dense")
    assert not any(kernels.counts()["plain_calls"].values())
    auto = sequence.attention(q, k, v, causal=True, impl="auto")
    assert kernels.counts()["plain_calls"]["flash_attention"] == 1
    np.testing.assert_allclose(dense.numpy(), auto.numpy(), **FWD)
    with pytest.raises(ValueError, match="several cards"):
        sequence.attention(q, k, v, impl="ulysses")


def test_stream_wrappers_refuse_lists_they_cannot_take():
    q = torch.zeros(1, 8, 1, 4)
    with pytest.raises(ValueError, match="non-causal"):
        fa.flash_attention_stream(q, q, q, causal=False, pairs="triangle")
    with pytest.raises(ValueError, match="'triangle' or 'rectangle'"):
        fa.flash_attention_stream(q, q, q, pairs="diagonal")
    with pytest.raises(ValueError, match="unit_tiles"):
        fa.stream_schedule(64, True, "row", 0)
