"""Attention kernels (counterpart of
`deeplearning4j_tpu/kernels/flash_attention.py`).

- `flash_attention` (prefill, `output`): the CUDA kernel of
  `csrc/flash_attention.cu` for CUDA tensors, replacing the TPU kernel
  `_flash_kernel_resident` (flash_attention.py:99); `dense_attention`, the
  framework's dense path (`parallel/sequence.py`), for CPU tensors.
- `paged_decode_attention` (decode step): the CUDA kernel of
  `csrc/paged_attention.cu`, replacing `_paged_flash_kernel`
  (flash_attention.py:733), split over the key axis by the static
  `paged_split_plan` and merged in one launch; `paged_gather_dense`, a
  copy of `_paged_gather_dense` + `_cached_decode_attention`, for CPU
  tensors.

Both kernels take the JAX package's [B, T, H, D] layout as it comes out of
the Q/K/V projections: no transpose is materialized. Each source file's
note says what bounds its kernel on the H100 and how the design meets it.
The decode kernel has no backward: the decode path never differentiates.

Training (the custom_vjp `_flash_attention_pallas`, flash_attention.py:271):
- `flash_attention_fwd_lse`: the forward that also stores each row's
  log-sum-exp (csrc/flash_attention.cu, replacing `_flash_fwd_lse_kernel`
  :376); plain version `dense_attention_lse`.
- `flash_attention_bwd`: D = rowsum(do * o), then `flash_attention_bwd_dq`
  (dq over q tiles) and `flash_attention_bwd_dkv` (dk/dv over k tiles), p
  recomputed from lse (csrc/flash_attention_bwd.cu, replacing
  `_flash_bwd_dq_kernel` :386 and `_flash_bwd_dkv_kernel` :426); plain
  versions `flash_bwd_dq_plain` and `flash_bwd_dkv_plain`, the same
  recompute-from-lse formulas written densely.
- `FlashAttentionFn` ties them together; `flash_attention` goes through it
  whenever autograd records and an input requires grad.

Every flash row has two forms on the card, picked by dtype and head width
alone (`flash_variant`) and counted by form in `kernels.variant_launches`:
bf16 at D = 64 or 128 on the tensor cores (wgmma, the streamed tiles by
TMA), f32 and every other D on the CUDA cores. The resident rows' (3, 5,
6) tensor-core form is the streamed rows' tile kernels over a schedule of
one block per whole row or column of tiles (csrc/flash_attention_stream.cu
`block_work`): one launch, no workspace.

Long context (csrc/flash_attention_stream.cu). Where the K/V of one
(batch, head) outgrow `_RESIDENT_KV_LIMIT` (`streamed`: 2·T·D·itemsize >
6 MiB, the JAX package's rule at :196, so T > 24,576 in bf16 and T >
12,288 in f32 at D = 64), all three places the JAX package decides
(`_flash_fwd_bhtd` :244, the custom_vjp's `_fwd` :314 and `_bwd` :333)
take the streamed kernels instead, here as there, by shape and dtype alone:
- `flash_attention_stream` (row 4, `_flash_stream_kernel` :137): (o, lse),
  or o alone for the no-grad forward; its unit kernel runs on the tensor
  cores (wgmma, K/V by TMA) for bf16 at D = 64 or 128 and on the CUDA cores
  otherwise (`flash_variant`);
- `flash_attention_bwd_dq_stream` and `flash_attention_bwd_dkv_stream`
  (row 7, `_flash_bwd_dq_stream_kernel` :551 and
  `_flash_bwd_dkv_stream_kernel` :595), D = rowsum(do * o) a torch
  expression in f32 as at :648; their unit kernels, too, run on the
  tensor cores for bf16 at D = 64 or 128 (`flash_variant`).
They walk the (q tile, k tile) visit list of `pair_arrays` (a copy of
`_pair_arrays` :113) at the port's 64-row tiles, cut into units of equal
work (`stream_schedule`). Their plain versions walk the same list a tile
row (or column) at a time with an exact softmax or recompute over the
tiles it visits: B·H·64·T floats at most, never [T, T].
One difference from the JAX package, on purpose: at a T that is no
multiple of its 256-row block the JAX package falls back to dense XLA
attention (:281, :308-312), which holds [T, T] at long T; the streamed
kernels take any T and mask the ragged tile.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build, _diff
from deeplearning4j_tpu_torch.kernels.norm_act import DTYPE_CODES

_NEG = -1e30
_MAX_DIM = 128     # csrc kernels: head dims held per thread/lane
_MAX_QUERIES = 8   # csrc/paged_attention.cu kMaxQ


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def _default_scale(q, scale):
    return scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _bhtd(*ts):
    """[B, T, H, D] tensors as [B, H, T, D] in the accumulation dtype."""
    return [a.transpose(1, 2).to(_acc_dtype(a.dtype)) for a in ts]


def _masked_scores(q_, k_, causal, scale):
    """s = q k^T * scale over [B, H, T, T], future keys at the JAX package's
    -1e30 when causal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q_, k_) * scale
    if causal:
        t = s.shape[-1]
        upper = torch.triu(torch.ones(t, t, dtype=torch.bool,
                                      device=s.device), 1)
        s = s.masked_fill(upper, _NEG)
    return s


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Plain version of `flash_attention`: q/k/v [B, T, H, D] -> [B, T, H, D]
    through a materialized [T, T] softmax."""
    kernels.plain_calls["flash_attention"].add()
    return dense(q, k, v, causal, scale)


def dense(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Dense attention, uncounted: the function itself, which
    `parallel.sequence.dense_attention` offers as `impl="dense"`."""
    q_, k_, v_ = _bhtd(q, k, v)
    p = torch.softmax(_masked_scores(q_, k_, causal,
                                     _default_scale(q, scale)), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v_)
    return o.transpose(1, 2).to(q.dtype)


def dense_attention_lse(q, k, v, causal: bool = True,
                        scale: Optional[float] = None):
    """Plain version of `flash_attention_fwd_lse`: (o [B, T, H, D],
    lse [B, H, T] f32), lse = logsumexp of each row's scaled scores."""
    kernels.plain_calls["flash_attention_fwd_lse"].add()
    q_, k_, v_ = _bhtd(q, k, v)
    s = _masked_scores(q_, k_, causal, _default_scale(q, scale))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), v_)
    return o.transpose(1, 2).to(q.dtype), lse.float()


def _bwd_terms(q, k, v, do, lse, drow, causal, scale):
    """p = exp(s - lse) and ds = p * (do v^T - D) over [B, H, T, T]."""
    q_, k_, v_, do_ = _bhtd(q, k, v, do)
    p = torch.exp(_masked_scores(q_, k_, causal, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do_, v_)
    return q_, k_, do_, p, p * (dp - drow[..., None])


def flash_bwd_dq_plain(q, k, v, do, lse, drow, causal, scale):
    """Plain version of the dq kernel: dq = ds k * scale."""
    kernels.plain_calls["flash_attention_bwd_dq"].add()
    _, k_, _, _, ds = _bwd_terms(q, k, v, do, lse, drow, causal, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k_) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, drow, causal, scale):
    """Plain version of the dk/dv kernel: dk = ds^T q * scale, dv = p^T do."""
    kernels.plain_calls["flash_attention_bwd_dkv"].add()
    q_, _, do_, p, ds = _bwd_terms(q, k, v, do, lse, drow, causal, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q_) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do_)
    return (dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


def _check_cuda(name, ts, dtype):
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {dtype}")
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _check_qkv(name, q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, T, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_cuda(name, (q, k, v), q.dtype)
    _diff.refuse_grad(name, q, k, v)
    b, t, h, d = q.shape
    if d > _MAX_DIM or b * h > 65535:  # 65535: the grid's y limit
        raise ValueError(f"{name} kernel takes D <= {_MAX_DIM} and "
                         f"B*H <= 65535, got D={d}, B*H={b * h}")
    return b, t, h, d


def _check_tma(name, *ts):
    """TMA reads a tensor through a map over its contiguous layout
    (`_check_cuda` refuses any other) from a 16-byte-aligned base: refuse
    a misaligned one before a launch."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} (tensor cores) takes tensors at "
                             f"16-byte-aligned addresses; got one at "
                             f"{t.data_ptr():#x}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# The two forms of every flash row's kernel and their codes in the C entries.
_VARIANTS = {"cuda_cores": 0, "wgmma": 1}


def flash_variant(dtype, d: int) -> str:
    """Which form of its kernel a flash row launches, by dtype and head
    width alone: "wgmma" (every product on the tensor cores, the streamed
    tiles by TMA) for bf16 at D = 64 or 128, "cuda_cores" for f32 and every
    other D. One rule for the resident rows 3, 5 and 6 and the streamed
    rows 4 and 7 (whose tile kernels the resident rows' form shares). A
    dispatch by shape, not a fallback: a wgmma launch that fails raises.

    The tensor-core form reads q, k, v (and do) by TMA, from contiguous
    tensors at 16-byte-aligned addresses: the wrappers refuse any other
    before a launch and never hand it to the CUDA-core form. An upstream op
    may hand autograd a contiguous gradient at an odd address, so
    `FlashAttentionFn.backward` gives the backward a fresh copy of do (the
    caching allocator's blocks are 512-byte aligned) when, and only when,
    do.data_ptr() % 16 != 0. q, k and v are the forward's inputs, which
    its own tensor-core form already took."""
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) \
        else "cuda_cores"


resident_variant = stream_fwd_variant = stream_bwd_variant = flash_variant


def _variant(name, d, *ts):
    """The form `name` launches for `ts` (q first), refusing before the
    launch what the tensor-core form cannot read."""
    variant = flash_variant(ts[0].dtype, d)
    if variant == "wgmma":
        _check_tma(name, *ts)
    return variant


def _counted(name, variant):
    kernels.launches[name].add()
    kernels.variant_launches[name][variant].add()


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Multi-head attention forward, q/k/v [B, T, H, D] -> [B, T, H, D]
    (the kernel takes any T and D <= 128). Differentiable through
    `FlashAttentionFn` when autograd records. Past the resident limit
    (`streamed`) the streamed forward runs and its lse is dropped, as
    `_flash_fwd_bhtd` (:259) drops it."""
    scale = _default_scale(q, scale)
    if _diff.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    if streamed(q):
        return flash_attention_stream(q, k, v, causal, scale, with_lse=False)
    if kernels.placement(q, k, v) == "cpu":
        return dense_attention(q, k, v, causal, scale)
    b, t, h, d = _check_qkv("flash_attention", q, k, v)
    variant = _variant("flash_attention", d, q, k, v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), b, t, h, d, int(causal),
                      float(scale), DTYPE_CODES[q.dtype], _VARIANTS[variant],
                      _stream(q))
    _counted("flash_attention", variant)
    return o


def flash_attention_fwd_lse(q, k, v, causal: bool = True,
                            scale: Optional[float] = None):
    """Training forward: (o [B, T, H, D], lse [B, H, T] f32). One launch,
    in the form `flash_variant` picks."""
    scale = _default_scale(q, scale)
    if kernels.placement(q, k, v) == "cpu":
        return dense_attention_lse(q, k, v, causal, scale)
    name = "flash_attention_fwd_lse"
    b, t, h, d = _check_qkv(name, q, k, v)
    variant = _variant(name, d, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_fwd_lse", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), b, t, h, d, int(causal), float(scale),
                      DTYPE_CODES[q.dtype], _VARIANTS[variant], _stream(q))
    _counted(name, variant)
    return o, lse


def _check_bwd(name, q, k, v, do, lse, drow):
    b, t, h, d = _check_qkv(name, q, k, v)
    _check_cuda(name, (do,), q.dtype)
    if do.shape != q.shape:
        raise ValueError(f"do must be {tuple(q.shape)}, got {tuple(do.shape)}")
    for what, a in (("lse", lse), ("drow", drow)):
        if (a.dtype != torch.float32 or tuple(a.shape) != (b, h, t)
                or not a.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous float32 "
                             f"[{b}, {h}, {t}]")
    return b, t, h, d


def _bwd_args(q, k, v, do, lse, drow):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), drow.data_ptr())


def flash_attention_bwd_dq(q, k, v, do, lse, drow, causal, scale):
    """dq from the recompute-from-lse formulas; drow = rowsum(do * o),
    [B, H, T] f32 like lse. One launch, in the form `flash_variant`
    picks."""
    if kernels.placement(q, k, v, do, lse, drow) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, drow, causal, scale)
    name = "flash_attention_bwd_dq"
    b, t, h, d = _check_bwd(name, q, k, v, do, lse, drow)
    variant = _variant(name, d, q, k, v, do)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_bwd_dq",
                      *_bwd_args(q, k, v, do, lse, drow), dq.data_ptr(), b, t,
                      h, d, int(causal), float(scale), DTYPE_CODES[q.dtype],
                      _VARIANTS[variant], _stream(q))
    _counted(name, variant)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, drow, causal, scale):
    """(dk, dv) from the recompute-from-lse formulas (see the dq half)."""
    if kernels.placement(q, k, v, do, lse, drow) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, drow, causal, scale)
    name = "flash_attention_bwd_dkv"
    b, t, h, d = _check_bwd(name, q, k, v, do, lse, drow)
    variant = _variant(name, d, q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_bwd_dkv",
                      *_bwd_args(q, k, v, do, lse, drow), dk.data_ptr(),
                      dv.data_ptr(), b, t, h, d, int(causal), float(scale),
                      DTYPE_CODES[q.dtype], _VARIANTS[variant], _stream(q))
    _counted(name, variant)
    return dk, dv


def _drow(o, do):
    """D = rowsum(do * o) in f32 as [B, H, T], as the JAX package computes it
    in XLA (flash_attention.py:502, :648)."""
    if o.shape != do.shape:
        raise ValueError(f"o must be {tuple(do.shape)}, got {tuple(o.shape)}")
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of `flash_attention` from the forward's o and
    lse and the incoming gradient do (all [B, T, H, D]; lse [B, H, T] f32),
    through the resident kernels (rows 5-6's backward)."""
    scale = _default_scale(q, scale)
    drow = _drow(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, drow, causal, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, drow, causal,
                                         scale))


class FlashAttentionFn(torch.autograd.Function):
    """The custom_vjp of `_flash_attention_pallas` (flash_attention.py:271):
    forward with lse, backward from (q, k, v, o, lse). The forward picks the
    resident or the streamed kernels by `streamed` (as `_fwd` :314 does) and
    the backward follows its choice (`_bwd` :333 applies the same rule);
    each wrapper picks the kernel or its plain version by where the tensors
    lie."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.streamed = streamed(q)
        fwd = flash_attention_stream if ctx.streamed else \
            flash_attention_fwd_lse
        o, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if do.data_ptr() % 16:  # see flash_variant: a fresh, aligned copy
            do = do.clone()
        bwd = flash_attention_bwd_stream if ctx.streamed else \
            flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# ------------------------------------------------------------ streamed
#
# Rows 4 and 7. The TPU kernels walk a scalar-prefetched list of (q block,
# k block) pairs, one pair per sequential grid step, carrying (acc, m, l)
# or the dq / dk-dv sums in VMEM scratch along a row (or column) of the
# list. A Hopper block cannot carry anything to the next block, and the
# rows of a causal list run from 1 tile to T/64: so the list's runs are cut
# into units of at most `_UNIT_TILES` tiles, one block each (split-K over
# the triangle, as flash-decoding splits a long cache). A run of one unit
# writes its output; a longer run writes partial sums to a workspace that a
# second kernel combines (log-sum-exp form for the forward, plain sums for
# the backward), in a fixed order and with no atomics.

_RESIDENT_KV_LIMIT = 6 * 1024 * 1024  # the JAX package's, flash_attention.py:196
_TILE = 64          # q rows and keys per tile (csrc/flash_attention_stream.cu)
# Tiles per unit: 64 tiles of 64 keys. At the slice's shape (B*H = 8,
# T = 32,768, causal) that is 2,304 units per (batch, head), 18,432 blocks
# in all: of 256 threads, ~2-3 resident on each of the 132 SMs, for the
# CUDA-core kernels (f32); of one 128-thread warpgroup for the bf16 kernels
# on the tensor cores, 3 per SM for the forward (~58 KB of shared memory)
# and dq (~66 KB), 2 for dk/dv (176 registers a thread; ptxas in PERF.md
# §6). Either way tens of waves, so the last wave's idle tail is a few
# percent, while each unit's fixed cost (its held tiles, its partial sums)
# stays under 2% of its work. Read at each call: the card tests lower it
# to make runs of several units at small T, and chip_smoke.py's
# long_parity to reorder the sums.
_UNIT_TILES = 64


def streamed(q) -> bool:
    """The JAX package's dispatch rule: the K/V of one (batch, head) of
    `q`'s shape and dtype outgrow the resident limit."""
    return 2 * q.shape[1] * q.shape[-1] * q.element_size() > \
        _RESIDENT_KV_LIMIT


@functools.lru_cache(maxsize=64)
def pair_arrays(nq: int, nk: int, block_q: int, block_k: int, causal: bool,
                order: str):
    """The streamed (q-block i, k-block j) visit sequence (a copy of
    `_pair_arrays`, flash_attention.py:113). Causal sequences cover only
    the lower triangle. `order="row"` (i-major: forward, dq) or `"col"`
    (j-major: dk/dv)."""
    pairs = []
    if order == "row":
        for i in range(nq):
            jm = min(nk - 1, ((i + 1) * block_q - 1) // block_k) \
                if causal else nk - 1
            pairs += [(i, j) for j in range(jm + 1)]
    else:
        for j in range(nk):
            i0 = (j * block_k) // block_q if causal else 0
            pairs += [(i, j) for i in range(i0, nq)]
    i_idx = np.asarray([p[0] for p in pairs], np.int32)
    j_idx = np.asarray([p[1] for p in pairs], np.int32)
    return i_idx, j_idx


def _list_is_triangle(causal, pairs):
    """`pairs`: "triangle" (the causal list), "rectangle" (every pair,
    masked in compute: row 13's comparison) or None (the one `causal`
    calls for)."""
    if pairs is None:
        return bool(causal)
    if pairs not in ("triangle", "rectangle"):
        raise ValueError(f"pairs must be 'triangle' or 'rectangle', got "
                         f"{pairs!r}")
    if pairs == "triangle" and not causal:
        raise ValueError("the triangular list leaves out keys that full "
                         "(non-causal) attention needs")
    return pairs == "triangle"


def _runs(t, triangle, order):
    """The list's runs at the port's tiles: (outer tile, first pair index,
    pairs) per q tile ("row") or k tile ("col"), in list order."""
    n = -(-t // _TILE)
    i_idx, j_idx = pair_arrays(n, n, _TILE, _TILE, triangle, order)
    outer = i_idx if order == "row" else j_idx
    starts = np.flatnonzero(np.r_[True, outer[1:] != outer[:-1]])
    counts = np.diff(np.r_[starts, len(outer)])
    return i_idx, j_idx, outer[starts], starts, counts


class Schedule(NamedTuple):
    """A visit list cut into units (numpy int32 arrays)."""
    pairs: np.ndarray   # [2, P]: q tile, k tile of each visit
    units: np.ndarray   # [U, 3]: first pair, pairs, partial slot or -1
    merges: np.ndarray  # [M, 3]: outer tile, first slot, slots
    n_slots: int


@functools.lru_cache(maxsize=64)
def stream_schedule(t: int, triangle: bool, order: str,
                    unit_tiles: int) -> Schedule:
    """Cut each run of the visit list into ceil(run / unit_tiles) units of
    near-equal length. A run of one unit writes the output itself (slot
    -1); a longer run's units get consecutive partial slots and one merge
    entry. Units are ordered longest first, so the last wave on the card
    holds the shortest."""
    if unit_tiles < 1:
        raise ValueError(f"unit_tiles must be >= 1, got {unit_tiles}")
    i_idx, j_idx, outer, starts, counts = _runs(t, triangle, order)
    units, merges, slot = [], [], 0
    for tile, first, run in zip(outer.tolist(), starts.tolist(),
                                counts.tolist()):
        parts = -(-run // unit_tiles)
        if parts == 1:
            units.append((first, run, -1))
            continue
        merges.append((tile, slot, parts))
        edges = [first + run * u // parts for u in range(parts + 1)]
        for u in range(parts):
            units.append((edges[u], edges[u + 1] - edges[u], slot))
            slot += 1
    units = np.asarray(units, np.int32).reshape(-1, 3)
    units = units[np.argsort(-units[:, 1], kind="stable")]
    return Schedule(np.stack([i_idx, j_idx]), units,
                    np.asarray(merges, np.int32).reshape(-1, 3), slot)


@functools.lru_cache(maxsize=64)
def _schedule_on(device, t, triangle, order, unit_tiles):
    """`stream_schedule`'s arrays as int32 tensors on `device`, made once
    per (shape, device)."""
    sch = stream_schedule(t, triangle, order, unit_tiles)
    return (*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in (sch.pairs, sch.units, sch.merges)), sch)


def stream_workspace_bytes(b, t, h, d, causal=True, pairs=None):
    """Bytes of the partial sums each streamed wrapper allocates: forward
    (acc, m, l), dq, and dk + dv (f32)."""
    tri = _list_is_triangle(causal, pairs)
    row = stream_schedule(t, tri, "row", _UNIT_TILES).n_slots
    col = stream_schedule(t, tri, "col", _UNIT_TILES).n_slots
    per = b * h * _TILE * 4
    return {"forward": row * per * (d + 2), "dq": row * per * d,
            "dkv": 2 * col * per * d}


def _causal_mask(s, r0, c0, causal):
    """s [.., rows, keys] with rows from r0 and keys from c0: future keys at
    the JAX package's -1e30."""
    if not causal:
        return s
    qpos = torch.arange(r0, r0 + s.shape[-2], device=s.device)
    kpos = torch.arange(c0, c0 + s.shape[-1], device=s.device)
    return s.masked_fill(kpos[None, :] > qpos[:, None], _NEG)


def _spans(t, triangle, order):
    """Per run of the visit list: the outer tile's element range and the
    contiguous element range of the tiles it visits."""
    i_idx, j_idx, outer, starts, counts = _runs(t, triangle, order)
    inner = j_idx if order == "row" else i_idx
    for tile, first, run in zip(outer.tolist(), starts.tolist(),
                                counts.tolist()):
        lo, hi = int(inner[first]), int(inner[first + run - 1]) + 1
        yield (tile * _TILE, min((tile + 1) * _TILE, t),
               lo * _TILE, min(hi * _TILE, t))


def flash_stream_fwd_plain(q, k, v, causal, scale, pairs=None):
    """Plain version of row 4: a q tile at a time, an exact softmax over
    the keys of the tiles its row of the list visits (masked keys weigh
    exp(-1e30 - lse) = 0). Returns (o [B, T, H, D], lse [B, H, T] f32)."""
    kernels.plain_calls["flash_attention_stream"].add()
    triangle = _list_is_triangle(causal, pairs)
    q_, k_, v_ = _bhtd(q, k, v)
    o = torch.empty_like(q_)
    lse = torch.empty(q_.shape[:3], dtype=q_.dtype, device=q.device)
    for r0, r1, c0, c1 in _spans(q.shape[1], triangle, "row"):
        s = _causal_mask(torch.einsum("bhqd,bhkd->bhqk", q_[:, :, r0:r1],
                                      k_[:, :, c0:c1]) * scale,
                         r0, c0, causal)
        lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1)
        o[:, :, r0:r1] = torch.einsum(
            "bhqk,bhkd->bhqd", torch.exp(s - lse[:, :, r0:r1, None]),
            v_[:, :, c0:c1])
    return o.transpose(1, 2).to(q.dtype), lse.float()


def _stream_bwd_terms(q_, k_, v_, do_, lse, drow, r0, r1, c0, c1, causal,
                      scale):
    """p = exp(s - lse) and ds = p * (do v^T - D) over rows [r0, r1) and
    keys [c0, c1)."""
    s = _causal_mask(torch.einsum("bhqd,bhkd->bhqk", q_[:, :, r0:r1],
                                  k_[:, :, c0:c1]) * scale, r0, c0, causal)
    p = torch.exp(s - lse[:, :, r0:r1, None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do_[:, :, r0:r1], v_[:, :, c0:c1])
    return p, p * (dp - drow[:, :, r0:r1, None])


def flash_stream_bwd_dq_plain(q, k, v, do, lse, drow, causal, scale,
                              pairs=None):
    """Plain version of row 7's dq: a q tile at a time over the keys its
    row of the list visits, dq = ds k * scale."""
    kernels.plain_calls["flash_attention_bwd_dq_stream"].add()
    triangle = _list_is_triangle(causal, pairs)
    q_, k_, v_, do_ = _bhtd(q, k, v, do)
    lse_, drow_ = lse.to(q_.dtype), drow.to(q_.dtype)
    dq = torch.empty_like(q_)
    for r0, r1, c0, c1 in _spans(q.shape[1], triangle, "row"):
        _, ds = _stream_bwd_terms(q_, k_, v_, do_, lse_, drow_, r0, r1, c0,
                                  c1, causal, scale)
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds,
                                       k_[:, :, c0:c1]) * scale
    return dq.transpose(1, 2).to(q.dtype)


def flash_stream_bwd_dkv_plain(q, k, v, do, lse, drow, causal, scale,
                               pairs=None):
    """Plain version of row 7's dk/dv: a k tile at a time over the queries
    its column of the list visits, dk = ds^T q * scale, dv = p^T do."""
    kernels.plain_calls["flash_attention_bwd_dkv_stream"].add()
    triangle = _list_is_triangle(causal, pairs)
    q_, k_, v_, do_ = _bhtd(q, k, v, do)
    lse_, drow_ = lse.to(q_.dtype), drow.to(q_.dtype)
    dk, dv = torch.empty_like(k_), torch.empty_like(v_)
    for c0, c1, r0, r1 in _spans(q.shape[1], triangle, "col"):
        p, ds = _stream_bwd_terms(q_, k_, v_, do_, lse_, drow_, r0, r1, c0,
                                  c1, causal, scale)
        dk[:, :, c0:c1] = torch.einsum("bhqk,bhqd->bhkd", ds,
                                       q_[:, :, r0:r1]) * scale
        dv[:, :, c0:c1] = torch.einsum("bhqk,bhqd->bhkd", p,
                                       do_[:, :, r0:r1])
    return (dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


def _sched_args(sch_t):
    pairs, units, merges, sch = sch_t
    return (pairs.data_ptr(), pairs[1].data_ptr(), units.data_ptr(),
            len(sch.units), merges.data_ptr(), len(sch.merges))


def _partials(b, h, n_slots, *tail, device):
    return torch.empty((b * h, n_slots, *tail), dtype=torch.float32,
                       device=device)


def flash_attention_stream(q, k, v, causal: bool = True,
                           scale: Optional[float] = None, *,
                           with_lse: bool = True, pairs=None):
    """Row 4: the streamed forward over the visit list (`pairs`, see
    `_list_is_triangle`), q/k/v [B, T, H, D], any T. Returns (o, lse
    [B, H, T] f32), or o alone without `with_lse`. One launch is counted
    per call, which issues the unit kernel (the form `flash_variant`
    picks, counted in `kernels.variant_launches`) and, when a run spans
    several units, the merge kernel.

    The tensor-core form (bf16 at D = 64 or 128) reads q/k/v by TMA, and
    so takes them contiguous and at 16-byte-aligned addresses: any other
    (a view at an odd element offset) raises ValueError before a launch,
    and is not handed to the CUDA-core form. The attention layer's q/k/v
    are fresh projection outputs of PyTorch's caching allocator, whose
    blocks are 512-byte aligned, so the layers never pass one."""
    scale = _default_scale(q, scale)
    if kernels.placement(q, k, v) == "cpu":
        o, lse = flash_stream_fwd_plain(q, k, v, causal, scale, pairs)
        return (o, lse) if with_lse else o
    b, t, h, d = _check_qkv("flash_attention_stream", q, k, v)
    variant = _variant("flash_attention_stream", d, q, k, v)
    sch = _schedule_on(q.device, t, _list_is_triangle(causal, pairs), "row",
                       _UNIT_TILES)
    n_slots = sch[3].n_slots
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    acc = _partials(b, h, n_slots, _TILE, d, device=q.device)
    ml = _partials(b, h, n_slots, 2, _TILE, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_stream_fwd", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      *_sched_args(sch), acc.data_ptr(), ml.data_ptr(),
                      n_slots, b, t, h, d, int(causal), float(scale),
                      DTYPE_CODES[q.dtype], _VARIANTS[variant], _stream(q))
    _counted("flash_attention_stream", variant)
    return (o, lse) if with_lse else o


def flash_attention_bwd_dq_stream(q, k, v, do, lse, drow, causal, scale, *,
                                  pairs=None):
    """Row 7's dq over the row-major list; drow = rowsum(do * o), [B, H, T]
    f32 like lse. One launch is counted per call (the unit kernel, in the
    form `flash_variant` picks, counted in `kernels.variant_launches`,
    and the sum kernel when a run spans several units)."""
    if kernels.placement(q, k, v, do, lse, drow) == "cpu":
        return flash_stream_bwd_dq_plain(q, k, v, do, lse, drow, causal,
                                         scale, pairs)
    name = "flash_attention_bwd_dq_stream"
    b, t, h, d = _check_bwd(name, q, k, v, do, lse, drow)
    variant = _variant(name, d, q, k, v, do)
    sch = _schedule_on(q.device, t, _list_is_triangle(causal, pairs), "row",
                       _UNIT_TILES)
    dq = torch.empty_like(q)
    part = _partials(b, h, sch[3].n_slots, _TILE, d, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_stream_bwd_dq",
                      *_bwd_args(q, k, v, do, lse, drow), dq.data_ptr(),
                      *_sched_args(sch), part.data_ptr(), sch[3].n_slots, b,
                      t, h, d, int(causal), float(scale),
                      DTYPE_CODES[q.dtype], _VARIANTS[variant], _stream(q))
    _counted(name, variant)
    return dq


def flash_attention_bwd_dkv_stream(q, k, v, do, lse, drow, causal, scale, *,
                                   pairs=None):
    """Row 7's (dk, dv) over the column-major list (see the dq half; one
    launch counted per call, of the unit kernel and up to two sums)."""
    if kernels.placement(q, k, v, do, lse, drow) == "cpu":
        return flash_stream_bwd_dkv_plain(q, k, v, do, lse, drow, causal,
                                          scale, pairs)
    name = "flash_attention_bwd_dkv_stream"
    b, t, h, d = _check_bwd(name, q, k, v, do, lse, drow)
    variant = _variant(name, d, q, k, v, do)
    sch = _schedule_on(q.device, t, _list_is_triangle(causal, pairs), "col",
                       _UNIT_TILES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part_dk, part_dv = (_partials(b, h, sch[3].n_slots, _TILE, d,
                                  device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_stream_bwd_dkv",
                      *_bwd_args(q, k, v, do, lse, drow), dk.data_ptr(),
                      dv.data_ptr(), *_sched_args(sch), part_dk.data_ptr(),
                      part_dv.data_ptr(), sch[3].n_slots, b, t, h, d,
                      int(causal), float(scale), DTYPE_CODES[q.dtype],
                      _VARIANTS[variant], _stream(q))
    _counted(name, variant)
    return dk, dv


def flash_attention_bwd_stream(q, k, v, o, lse, do, causal: bool = True,
                               scale: Optional[float] = None):
    """Row 7: (dq, dk, dv) of the streamed forward, D = rowsum(do * o) in
    f32 first (flash_attention.py:648)."""
    scale = _default_scale(q, scale)
    drow = _drow(o, do)
    dq = flash_attention_bwd_dq_stream(q, k, v, do, lse, drow, causal, scale)
    return (dq, *flash_attention_bwd_dkv_stream(q, k, v, do, lse, drow,
                                                causal, scale))


def cached_decode_attention(q, kc, vc, pos, causal):
    """Decode-step attention against a fixed-size KV cache (copy of
    `nn/layers/attention.py::_cached_decode_attention`). q: [B, T, H, D],
    the new positions, globally at [pos, pos+T); kc/vc: [B, L, H, D];
    `pos` an int (every row at one cursor) or a [B] tensor of per-row
    cursors. Causal: query i sees keys <= pos+i."""
    b, t, h, d = q.shape
    length = kc.shape[1]
    acc = _acc_dtype(q.dtype)
    qt = q.transpose(1, 2).to(acc) * (d ** -0.5)
    kt = kc.transpose(1, 2).to(acc)
    vt = vc.transpose(1, 2).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
    kpos = torch.arange(length, device=q.device)
    pos_b = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    steps = torch.arange(t, device=q.device)[None, :]
    if causal:
        limit = pos_b + 1 + steps
    else:
        limit = (pos_b + t).expand(pos_b.shape[0], t)
    s = torch.where(kpos[None, None, None, :] < limit[:, None, :, None], s,
                    torch.full((), _NEG, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vt)
    return o.transpose(1, 2).to(q.dtype)


def paged_gather_dense(q, k_pages, v_pages, page_table, pos, causal):
    """Plain version of `paged_decode_attention`: gather the pages into the
    dense [B, NP*page, H, D] layout and attend as the dense stepper does.
    Garbage rows (zero page, pad tails) sit at masked key positions, whose
    softmax weight is exactly 0."""
    kernels.plain_calls["paged_decode_attention"].add()
    b = q.shape[0]
    n_pages = page_table.shape[1]
    _, page, h, d = k_pages.shape
    idx = page_table.long()
    kc = k_pages[idx].reshape(b, n_pages * page, h, d)
    vc = v_pages[idx].reshape(b, n_pages * page, h, d)
    return cached_decode_attention(q, kc, vc, pos, causal)


class PagedPlan(NamedTuple):
    """The paged decode kernel's static cut of the key axis: splits of
    `pages_per_split` whole logical pages (the last may be shorter),
    `n_splits` of them, each read in tiles of `tile` key rows."""
    pages_per_split: int
    n_splits: int
    tile: int


# Blocks the paged decode grid aims at (splits x heads x slots), per SM:
# enough that a decode step's whole read is in flight at once.
_PAGED_BLOCKS_PER_SM = 4
# The fewest keys a split holds where the table has that many.
_PAGED_MIN_SPLIT_KEYS = 32


def paged_tile_rows(d: int, itemsize: int) -> int:
    """Key rows of one tile of csrc/paged_attention.cu: 64 where a head
    row (D rounded up to 16 bytes) takes at most 128 bytes, 32 to 256, else
    16, so that two stages of K and V stay under 37 KB of shared memory."""
    chunk = 16 // itemsize
    row = -(-d // chunk) * chunk * itemsize
    return 64 if row <= 128 else 32 if row <= 256 else 16


@functools.lru_cache(maxsize=256)
def paged_split_plan(batch: int, heads: int, n_pages: int, page: int,
                     d: int, itemsize: int, sms: int = 132) -> PagedPlan:
    """The split of the key axis the wrapper hands the paged kernel, from
    static quantities alone (never from `pos`, which lies on the card):
    the fewest splits that give `_PAGED_BLOCKS_PER_SM` x `sms` blocks,
    at most one a page and at least `_PAGED_MIN_SPLIT_KEYS` keys a split,
    balanced to whole pages. At the serving shape (4 slots, 8 heads, 16
    pages of 64) that is one page a split: 512 blocks."""
    want = -(-_PAGED_BLOCKS_PER_SM * sms // (batch * heads))
    splits = max(1, min(n_pages, want,
                        n_pages * page // _PAGED_MIN_SPLIT_KEYS))
    per = -(-n_pages // splits)
    return PagedPlan(per, -(-n_pages // per), paged_tile_rows(d, itemsize))


class _PagedParams(ctypes.Structure):
    """The paged kernel's scalars (csrc/paged_attention.cu `PagedParams`),
    built once per shape and handed over by address: one pointer in place
    of twelve ctypes conversions a call."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "nq", "heads", "dim", "page", "n_pages", "pages_per_split",
        "n_splits", "tile", "causal", "dtype")] + [("scale", ctypes.c_float)]


_sm_counts = {}
# (shapes, dtypes, causal, device index, stream) of a call whose checks
# passed -> what `_paged_setup` returns: the scalars and the workspace.
_paged_launches = {}


def _sm_count(idx: int) -> int:
    n = _sm_counts.get(idx)
    if n is None:
        n = _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _paged_setup(q, k_pages, v_pages, page_table, pos, causal, idx):
    """The checks that depend on shapes and dtypes alone (raising as the
    kernel cannot take them), then the launch's scalars and its workspace:
    f32 partials (m, l, acc) for every split, and one int32 counter a
    (slot, head), zeroed here once and left at 0 by every launch. A
    workspace serves one (shape, stream): launches on one stream run in
    turn, so they never share it at once."""
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"want q [B, T, H, D] and pools [P, page, H, D]; "
                         f"got {tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, t, h, d = q.shape
    if k_pages.shape[2:] != (h, d):
        raise ValueError(f"pool heads/dims {tuple(k_pages.shape[2:])} != "
                         f"q's {(h, d)}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be [{b}, NP], got "
                         f"{tuple(page_table.shape)}")
    if pos.shape != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("page_table and pos must be int32")
    _check_cuda("paged_decode_attention", (q, k_pages, v_pages), q.dtype)
    if t > _MAX_QUERIES or d > _MAX_DIM:
        raise ValueError(f"paged kernel takes T <= {_MAX_QUERIES} and "
                         f"D <= {_MAX_DIM}; got T={t}, D={d}")
    page, n_pages = k_pages.shape[1], page_table.shape[1]
    plan = paged_split_plan(b, h, n_pages, page, d, q.element_size(),
                            _sm_count(idx))
    params = _PagedParams(b, t, h, d, page, n_pages, plan.pages_per_split,
                          plan.n_splits, plan.tile, int(causal),
                          DTYPE_CODES[q.dtype], d ** -0.5)
    part = torch.empty(b * h * plan.n_splits * t * (d + 2),
                       dtype=torch.float32, device=q.device)
    cnt = torch.zeros(b * h, dtype=torch.int32, device=q.device)
    return (params, part, cnt, ctypes.addressof(params), part.data_ptr(),
            cnt.data_ptr())


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, causal):
    """Decode attention through the paged KV pool. q: [B, T, H, D] (T <= 8
    on the card); k_pages/v_pages: [P, page, H, D]; page_table: [B, NP]
    int32 (0 = the zero page); pos: [B] int32 cursors. On the card one
    launch of the split kernel (`paged_split_plan`); nothing here reads
    `pos` or the table on the host. A decode step makes one call a block,
    so the launch path is kept short: the checks that depend on shapes and
    dtypes run once per shape, the scalars go over as one block."""
    idx = q.get_device()
    if not (idx >= 0 and k_pages.get_device() == idx
            and v_pages.get_device() == idx
            and page_table.get_device() == idx and pos.get_device() == idx):
        if kernels.placement(q, k_pages, v_pages, page_table, pos) == "cpu":
            return paged_gather_dense(q, k_pages, v_pages, page_table, pos,
                                      causal)
    stream = _build.current_stream(idx)
    key = (q.shape, k_pages.shape, v_pages.shape, page_table.shape,
           pos.shape, q.dtype, k_pages.dtype, v_pages.dtype,
           page_table.dtype, pos.dtype, bool(causal), idx, stream)
    setup = _paged_launches.get(key)
    if setup is None:
        setup = _paged_launches[key] = _paged_setup(
            q, k_pages, v_pages, page_table, pos, causal, idx)
    params, part, cnt = setup[3:]
    if not (q.is_contiguous() and k_pages.is_contiguous()
            and v_pages.is_contiguous()):
        raise ValueError("paged_decode_attention takes contiguous tensors")
    if not (page_table.is_contiguous() and pos.is_contiguous()):
        raise ValueError("page_table and pos must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k_pages.requires_grad
                                    or v_pages.requires_grad):
        _diff.refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    o = torch.empty_like(q)
    with _build.on_device(idx):
        _build.launch("dl4j_paged_decode_attention", q.data_ptr(),
                      k_pages.data_ptr(), v_pages.data_ptr(),
                      page_table.data_ptr(), pos.data_ptr(), o.data_ptr(),
                      part, cnt, params, stream)
    kernels.launches["paged_decode_attention"].add()
    return o
