"""Attention kernels of the serving path (counterpart of
`deeplearning4j_tpu/kernels/flash_attention.py`).

- `flash_attention` (prefill): the CUDA kernel of `csrc/flash_attention.cu`
  for CUDA tensors, replacing the TPU kernel `_flash_kernel_resident`
  (flash_attention.py:99); `dense_attention`, a copy of
  `parallel/sequence.py::dense_attention`, for CPU tensors.
- `paged_decode_attention` (decode step): the CUDA kernel of
  `csrc/paged_attention.cu`, replacing `_paged_flash_kernel`
  (flash_attention.py:733); `paged_gather_dense`, a copy of
  `_paged_gather_dense` + `_cached_decode_attention`, for CPU tensors.

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
"""

from __future__ import annotations

from typing import Optional

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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Multi-head attention forward, q/k/v [B, T, H, D] -> [B, T, H, D]
    (the kernel takes any T and D <= 128). Differentiable through
    `FlashAttentionFn` when autograd records."""
    scale = _default_scale(q, scale)
    if _diff.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, scale)
    if kernels.placement(q, k, v) == "cpu":
        return dense_attention(q, k, v, causal, scale)
    b, t, h, d = _check_qkv("flash_attention", q, k, v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), b, t, h, d, int(causal),
                      float(scale), DTYPE_CODES[q.dtype], _stream(q))
    kernels.launches["flash_attention"].add()
    return o


def flash_attention_fwd_lse(q, k, v, causal: bool = True,
                            scale: Optional[float] = None):
    """Training forward: (o [B, T, H, D], lse [B, H, T] f32)."""
    scale = _default_scale(q, scale)
    if kernels.placement(q, k, v) == "cpu":
        return dense_attention_lse(q, k, v, causal, scale)
    b, t, h, d = _check_qkv("flash_attention_fwd_lse", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_fwd_lse", q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), b, t, h, d, int(causal), float(scale),
                      DTYPE_CODES[q.dtype], _stream(q))
    kernels.launches["flash_attention_fwd_lse"].add()
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
    [B, H, T] f32 like lse."""
    if kernels.placement(q, k, v, do, lse, drow) == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, drow, causal, scale)
    b, t, h, d = _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, drow)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_bwd_dq",
                      *_bwd_args(q, k, v, do, lse, drow), dq.data_ptr(), b, t,
                      h, d, int(causal), float(scale), DTYPE_CODES[q.dtype],
                      _stream(q))
    kernels.launches["flash_attention_bwd_dq"].add()
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, drow, causal, scale):
    """(dk, dv) from the recompute-from-lse formulas (see the dq half)."""
    if kernels.placement(q, k, v, do, lse, drow) == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, drow, causal, scale)
    b, t, h, d = _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, drow)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_bwd_dkv",
                      *_bwd_args(q, k, v, do, lse, drow), dk.data_ptr(),
                      dv.data_ptr(), b, t, h, d, int(causal), float(scale),
                      DTYPE_CODES[q.dtype], _stream(q))
    kernels.launches["flash_attention_bwd_dkv"].add()
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of `flash_attention` from the forward's o and
    lse and the incoming gradient do (all [B, T, H, D]; lse [B, H, T] f32).
    D = rowsum(do * o) is computed here in f32, as the JAX package computes
    it in XLA (flash_attention.py:502)."""
    scale = _default_scale(q, scale)
    if o.shape != q.shape:
        raise ValueError(f"o must be {tuple(q.shape)}, got {tuple(o.shape)}")
    drow = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, drow, causal, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, drow, causal,
                                         scale))


class FlashAttentionFn(torch.autograd.Function):
    """The custom_vjp of `_flash_attention_pallas` (flash_attention.py:271):
    forward with lse, backward from (q, k, v, o, lse). Each half picks the
    kernel or its plain version by where the tensors lie."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


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


def paged_decode_attention(q, k_pages, v_pages, page_table, pos, causal):
    """Decode attention through the paged KV pool. q: [B, T, H, D] (T <= 8
    on the card); k_pages/v_pages: [P, page, H, D]; page_table: [B, NP]
    int32 (0 = the zero page); pos: [B] int32 cursors."""
    if kernels.placement(q, k_pages, v_pages, page_table, pos) == "cpu":
        return paged_gather_dense(q, k_pages, v_pages, page_table, pos,
                                  causal)
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
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be [{b}], got {tuple(pos.shape)}")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("page_table and pos must be int32")
    _check_cuda("paged_decode_attention", (q, k_pages, v_pages), q.dtype)
    _diff.refuse_grad("paged_decode_attention", q, k_pages, v_pages)
    if not (page_table.is_contiguous() and pos.is_contiguous()):
        raise ValueError("page_table and pos must be contiguous")
    if t > _MAX_QUERIES or d > _MAX_DIM:
        raise ValueError(f"paged kernel takes T <= {_MAX_QUERIES} and "
                         f"D <= {_MAX_DIM}; got T={t}, D={d}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_paged_decode_attention", q.data_ptr(),
                      k_pages.data_ptr(), v_pages.data_ptr(),
                      page_table.data_ptr(), pos.data_ptr(), o.data_ptr(),
                      b, t, h, d, k_pages.shape[1], page_table.shape[1],
                      int(causal), float(d ** -0.5), DTYPE_CODES[q.dtype],
                      _stream(q))
    kernels.launches["paged_decode_attention"].add()
    return o
