"""Row 8's split-KV design on the CPU: the static split plan the wrapper
hands `csrc/paged_attention.cu`, and the kernel's split-and-merge order,
emulated here in f32 torch (tiles of a split, one max and one sum per query
a tile, splits merged in split order) and held to the JAX package's Pallas
paged kernel in interpret mode at every split count, with empty splits, a
free slot, T = 1, 3 and 8 and both masks. f32 at 1e-5; inputs from one
numpy RandomState handed to both packages."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import flash_attention as jax_fa
from deeplearning4j_tpu.kernels import registry
from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = -1e30
# 4 slots, 2 heads of 8, pages of 4, 6 pages a row. Slot 0 runs past its
# table at T = 8 (cursor 19), slot 1 ends in its third page, slot 2 is free
# (all-zero table, cursor 0), slot 3 sits in its first page.
B, H, D, PAGE, NP = 4, 2, 8, 4, 6
POS = np.asarray([19, 9, 0, 2], np.int32)
TABLE = np.asarray([[3, 7, 1, 9, 5, 11], [2, 8, 4, 0, 0, 0],
                    [0, 0, 0, 0, 0, 0], [6, 0, 0, 0, 0, 0]], np.int32)
POOL = 12


def _inputs(t):
    rng = np.random.RandomState(40 + t)
    return (rng.randn(B, t, H, D).astype(np.float32),
            rng.randn(POOL, PAGE, H, D).astype(np.float32),
            rng.randn(POOL, PAGE, H, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_reference(t, causal):
    """The Pallas paged kernel (interpret mode) on `_inputs(t)`."""
    q, kp, vp = _inputs(t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DL4J_TPU_KERNEL_FLASH_ATTENTION_PAGED", "pallas")
        registry.clear_cache()
        out = jax_fa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(TABLE), jnp.asarray(POS), causal)
        out = np.asarray(out)
    registry.clear_cache()
    return out


def split_kernel_emulation(q, kp, vp, table, pos, causal, pages_per_split,
                           tile, weights=None):
    """csrc/paged_attention.cu's arithmetic in f32 torch, in its order: a
    (slot, head, split) block returns where its first key is past the row's
    key limit; else it walks its split in tiles of `tile` rows, per tile one
    max and one sum per query with invisible keys at weight 0, and keeps
    (m, l, acc); a row of one active split writes acc / l, else the splits
    merge in split order in one pass, each rescaling the running sums to
    the larger max. `weights`, a list, collects (query saw a key in the
    split, its weight) per merged split."""
    b_, t, h_, d = q.shape
    page, n_pages = kp.shape[1], table.shape[1]
    split_keys = pages_per_split * page
    scale = d ** -0.5
    o = torch.zeros_like(q)
    steps = torch.arange(t)
    for b in range(b_):
        p0 = int(pos[b])
        n_keys = min(p0 + t, n_pages * page)
        n_active = -(-n_keys // split_keys)
        limit = p0 + 1 + steps if causal else torch.full((t,), p0 + t)
        for h in range(h_):
            parts = []
            for s in range(-(-n_pages // pages_per_split)):
                if s >= n_active:
                    continue
                k0, k1 = s * split_keys, min((s + 1) * split_keys, n_keys)
                m = torch.full((t,), NEG)
                l = torch.zeros(t)
                acc = torch.zeros(t, d)
                for key0 in range(k0, k1, tile):
                    keys = torch.arange(key0, min(key0 + tile, k1))
                    phys = table[b, keys // page].long()
                    k = kp[phys, keys % page, h]
                    v = vp[phys, keys % page, h]
                    sc = (q[b, :, h] * scale) @ k.T
                    vis = keys[None, :] < limit[:, None]
                    mx = torch.where(vis, sc, torch.tensor(NEG)).amax(1)
                    m_new = torch.maximum(m, mx)
                    p = torch.where(vis, torch.exp(sc - m_new[:, None]),
                                    torch.tensor(0.0))
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ v
                    m = m_new
                parts.append((m, l, acc, (torch.arange(k0, k1)[None, :]
                                          < limit[:, None]).any(1)))
            if n_active == 1:
                m, l, acc, _ = parts[0]
                o[b, :, h] = acc / l.clamp(min=1e-30)[:, None]
                continue
            mx = torch.full((t,), NEG)
            big_l, big_a = torch.zeros(t), torch.zeros(t, d)
            for m, l, acc, saw in parts:
                m_new = torch.maximum(mx, m)
                c_old, w = torch.exp(mx - m_new), torch.exp(m - m_new)
                if weights is not None:
                    weights.extend(zip(saw.tolist(), w.tolist()))
                big_l = big_l * c_old + l * w
                big_a = big_a * c_old[:, None] + acc * w[:, None]
                mx = m_new
            o[b, :, h] = big_a / big_l.clamp(min=1e-30)[:, None]
    return o


@pytest.mark.parametrize("pages_per_split", range(1, NP + 1))
@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_split_and_merge_order_matches_the_jax_pallas_kernel(
        causal, t, pages_per_split):
    # Every split count from 6 (one page a split) to 1, each split read in
    # tiles of 16 rows (the kernel's f32 D = 128 tile) where it is longer.
    q, kp, vp = (torch.tensor(a) for a in _inputs(t))
    weights = []
    got = split_kernel_emulation(q, kp, vp, torch.tensor(TABLE),
                                 torch.tensor(POS), causal, pages_per_split,
                                 16, weights)
    np.testing.assert_allclose(got.numpy(), _jax_reference(t, causal), **TOL)
    # A split in which a query sees no key merges with weight exactly 0.
    assert all(w == 0.0 for saw, w in weights if not saw)


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_tiles_of_a_split_give_the_same_output(tile):
    q, kp, vp = (torch.tensor(a) for a in _inputs(3))
    got = split_kernel_emulation(q, kp, vp, torch.tensor(TABLE),
                                 torch.tensor(POS), True, NP, tile)
    np.testing.assert_allclose(got.numpy(), _jax_reference(3, True), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_a_free_slot_reads_the_zero_page(causal):
    # All-zero table at cursor 0: query t sees keys [0, t] (causal) or
    # [0, T) of page 0, as `paged_gather_dense` gives.
    q, kp, vp = (torch.tensor(a) for a in _inputs(3))
    got = split_kernel_emulation(q, kp, vp, torch.tensor(TABLE),
                                 torch.tensor(POS), causal, 1, 64)
    want = fa.paged_gather_dense(q, kp, vp, torch.tensor(TABLE),
                                 torch.tensor(POS), causal)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), **TOL)
    if causal:  # query 0 sees key 0 alone
        np.testing.assert_allclose(got[2, 0].numpy(), vp[0, 0].numpy(),
                                   **TOL)


def _splits(plan, n_pages):
    """The page ranges of a plan's splits."""
    return [(s * plan.pages_per_split,
             min((s + 1) * plan.pages_per_split, n_pages))
            for s in range(plan.n_splits)]


@pytest.mark.parametrize("batch,heads,n_pages,page,d,itemsize", [
    (4, 8, 16, 64, 64, 2),     # the serving shape
    (4, 8, 16, 64, 64, 4),
    (1, 1, 1, 4, 8, 4),        # one page
    (3, 2, 4, 4, 8, 4),        # the JAX package's test geometry
    (64, 8, 16, 64, 128, 2),   # a wide batch: few splits
    (2, 4, 256, 4, 64, 2),     # small pages: splits of several pages
    (1, 2, 37, 16, 128, 4),    # a page count no split count divides
    (32, 32, 7, 256, 64, 2),   # large pages, more blocks than the target
])
def test_split_plan_covers_the_keys_once_in_whole_pages(batch, heads,
                                                         n_pages, page, d,
                                                         itemsize):
    plan = fa.paged_split_plan(batch, heads, n_pages, page, d, itemsize)
    ranges = _splits(plan, n_pages)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_pages
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    covered = np.concatenate([np.arange(a * page, b * page)
                              for a, b in ranges])
    np.testing.assert_array_equal(covered, np.arange(n_pages * page))
    assert plan.tile == fa.paged_tile_rows(d, itemsize)


def test_split_plan_fills_the_card_at_the_serving_shape():
    plan = fa.paged_split_plan(4, 8, 16, 64, 64, 2, 132)
    blocks = 4 * 8 * plan.n_splits
    assert plan.pages_per_split == 1 and blocks == 512 and blocks >= 132
    assert plan.tile == 64
    # More SMs or fewer slots never mean fewer splits.
    assert fa.paged_split_plan(1, 8, 16, 64, 64, 2, 132).n_splits == 16
    assert fa.paged_split_plan(64, 8, 16, 64, 64, 2, 132).n_splits < 16


@pytest.mark.parametrize("itemsize", [2, 4])
def test_tile_rows_keep_two_stages_in_48_kb(itemsize):
    chunk = 16 // itemsize
    for d in range(1, 129):
        tile = fa.paged_tile_rows(d, itemsize)
        dr = -(-d // chunk) * chunk
        header = (8 * dr + 8 * 64 + 3 * 8 + 4) * 4
        assert tile in (16, 32, 64)
        assert header + 4 * tile * (dr + chunk) * itemsize <= 48 * 1024


def test_wrapper_hands_the_plan_and_workspace_to_the_c_entry(monkeypatch):
    # Without a card: what the wrapper would hand the C entry, against its
    # ctypes signature; nothing of pos or the table is read.
    calls = []

    def fake_launch(name, *args):
        sig = _build._SIGNATURES[name]
        assert len(args) == len(sig)
        assert all(isinstance(a, int) for a in args), args
        calls.append(args)

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(kernels, "placement", lambda *ts: "cuda")
    monkeypatch.setattr(_build, "on_device", lambda i: torch.no_grad())
    monkeypatch.setattr(_build, "current_stream", lambda i: 7)
    monkeypatch.setattr(fa, "_sm_count", lambda i: 132)
    monkeypatch.setattr(fa, "_paged_launches", {})
    q = torch.zeros(4, 1, 8, 64, dtype=torch.bfloat16)
    pool = torch.zeros(65, 64, 8, 64, dtype=torch.bfloat16)
    table = torch.zeros(4, 16, dtype=torch.int32)
    pos = torch.zeros(4, dtype=torch.int32)
    before = kernels.launches["paged_decode_attention"].value
    out = fa.paged_decode_attention(q, pool, pool, table, pos, True)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert kernels.launches["paged_decode_attention"].value == before + 1
    (args,) = calls
    params = fa._PagedParams.from_address(args[8])
    assert [getattr(params, f) for f, _ in params._fields_] == [
        4, 1, 8, 64, 64, 16, 1, 16, 64, 1, 1, np.float32(64 ** -0.5)]
    assert args[9] == 7  # the stream
    # The workspace: m, l and acc of every split, a zeroed counter a
    # (slot, head).
    (setup,) = fa._paged_launches.values()
    _, part, cnt = setup[:3]
    assert part.numel() == 4 * 8 * 16 * 1 * 66 and part.dtype == torch.float32
    assert cnt.dtype == torch.int32 and cnt.tolist() == [0] * 32
    assert args[6:8] == (part.data_ptr(), cnt.data_ptr())
    # A second call of the same shape on the same stream reuses both.
    fa.paged_decode_attention(q, pool, pool, table, pos, True)
    assert calls[1][6:9] == args[6:9]
    with pytest.raises(ValueError, match="T <= 8"):
        fa.paged_decode_attention(torch.zeros(4, 9, 8, 64,
                                              dtype=torch.bfloat16),
                                  pool, pool, table, pos, True)
    with pytest.raises(TypeError, match="int32"):
        fa.paged_decode_attention(q, pool, pool, table.long(), pos, True)
