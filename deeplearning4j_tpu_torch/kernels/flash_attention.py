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
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels.norm_act import DTYPE_CODES

_NEG = -1e30
_MAX_DIM = 128     # csrc kernels: head dims held per thread/lane
_MAX_QUERIES = 8   # csrc/paged_attention.cu kMaxQ


def _acc_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def dense_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Plain version of `flash_attention`: q/k/v [B, T, H, D] -> [B, T, H, D]
    through a materialized [T, T] softmax."""
    kernels.plain_calls["flash_attention"].add()
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    acc = _acc_dtype(q.dtype)
    q_, k_, v_ = (a.transpose(1, 2).to(acc) for a in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q_, k_) * scale
    if causal:
        t = s.shape[-1]
        upper = torch.triu(torch.ones(t, t, dtype=torch.bool,
                                      device=s.device), 1)
        s = s.masked_fill(upper, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v_)
    return o.transpose(1, 2).to(q.dtype)


def _check_cuda(name, ts, dtype):
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {dtype}")
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None):
    """Multi-head attention forward, q/k/v [B, T, H, D] -> [B, T, H, D]
    (the kernel takes any T and D <= 128)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if kernels.placement(q, k, v) == "cpu":
        return dense_attention(q, k, v, causal, scale)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, T, H, D] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    _check_cuda("flash_attention", (q, k, v), q.dtype)
    b, t, h, d = q.shape
    if d > _MAX_DIM or b * h > 65535:  # 65535: the grid's y limit
        raise ValueError(f"flash_attention kernel takes D <= {_MAX_DIM} and "
                         f"B*H <= 65535, got D={d}, B*H={b * h}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch("dl4j_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), b, t, h, d, int(causal),
                      float(scale), DTYPE_CODES[q.dtype],
                      torch.cuda.current_stream(q.device).cuda_stream)
    kernels.launches["flash_attention"].add()
    return o


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
                      torch.cuda.current_stream(q.device).cuda_stream)
    kernels.launches["paged_decode_attention"].add()
    return o
