"""Multi-head self-attention of the serving slice (counterpart of
`deeplearning4j_tpu/nn/layers/attention.py::self_attention_apply`).

Four paths, picked from the state and the mask the layer is given:

1. `k_pages` in state (paged decode step): scatter the new k/v rows
   through the per-slot page table into the pools, then read through
   `paged_decode_attention`;
2. `kv_pos` in state (dense cached decode step): write the new rows at the
   cursor, then `cached_decode_attention` (the reference leaves this path
   to XLA: it has no TPU kernel);
3. a [B, T] features mask with a full sequence: `_masked_dense_attention`,
   dense attention in plain PyTorch with the masked keys left out, as the
   reference routes a masked batch (attention.py:209-210) to XLA and not
   to its flash kernel: the JAX package has no kernel on this path;
4. otherwise (a full sequence: prefill, `output`, training):
   `parallel.sequence.attention` with the layer's `attention_impl`:
   "auto" is flash attention (through `FlashAttentionFn` when autograd
   records; the streamed kernels past the resident K/V limit), "dense" the
   dense path; with `decode_cache_length` set, prime the cache as
   undeclared state.

Unlike the reference's functional `.at[].set`, the decode paths write the
KV pools and caches IN PLACE: the previous state is dead after a step, and
a copy of every pool per layer per step is the bytes the step can least
afford. The layer's input takes dropout at train time (`common.py`).
Ring/Ulysses attention ("ulysses" is refused) and tensor parallelism are
not in the port yet.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.kernels import flash_attention as _fa
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.common import layer_input_dropout
from deeplearning4j_tpu_torch.parallel import sequence as _seq

_NEG = -1e30


def _masked_dense_attention(q, k, v, mask, causal, scale):
    """Dense attention with key masking (reference
    `_masked_dense_attention`, attention.py:36-56). q, k, v: [B, T, H, D];
    mask [B, T] (1 real, 0 padding). In f32 at least
    (`promote_types(q.dtype, f32)`); masked keys get -1e30 before the
    softmax, a fully masked row gives zeros, then the causal mask if
    set."""
    acc = torch.promote_types(q.dtype, torch.float32)
    qt, kt, vt = (a.transpose(1, 2).to(acc) for a in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    s = torch.where(mask[:, None, None, :] > 0, s, _NEG)
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                     device=s.device).triu(1), _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(m <= _NEG / 2, 0.0, p)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p / denom, vt)
    return o.transpose(1, 2).to(q.dtype)


def self_attention_apply(conf, params, state, x, train=False, mask=None,
                         rng=None):
    """x: [B, T, n_in] -> [B, T, n_out]."""
    if conf.attention_impl not in _seq.IMPLS:
        raise ValueError(f"attention_impl {conf.attention_impl!r} is not in "
                         f"the port (it runs {', '.join(_seq.IMPLS)}; ring "
                         "and Ulysses need several cards, ROADMAP A.13)")
    x = layer_input_dropout(conf, x, rng, train)
    b, t, _ = x.shape
    heads = conf.n_heads
    if conf.n_out % heads:
        raise ValueError(f"SelfAttentionLayer n_out ({conf.n_out}) must be "
                         f"divisible by n_heads ({heads})")
    dh = conf.n_out // heads
    q = (x @ params["Wq"] + params["qB"]).view(b, t, heads, dh)
    k = (x @ params["Wk"]).view(b, t, heads, dh)
    v = (x @ params["Wv"] + params["vB"]).view(b, t, heads, dh)
    act = activations.resolve(conf.activation)

    def project(o):
        return act(o.reshape(b, t, conf.n_out) @ params["Wo"] + params["oB"])

    cap = conf.decode_cache_length
    if cap and "k_pages" in state:
        pos = state["kv_pos"]                   # [B] int32 cursors
        table = state["page_table"]             # [B, NP] int32
        kp, vp = state["k_pages"], state["v_pages"]
        page = kp.shape[1]
        gpos = pos[:, None].long() + torch.arange(t, device=x.device)[None, :]
        # Free slots' cursors grow unbounded; the clip keeps the gather
        # legal, and their all-zero table rows land the writes on the
        # reserved zero page, which is never read unmasked.
        phys = torch.gather(table.long(), 1,
                            (gpos // page).clamp(0, table.shape[1] - 1))
        flat_phys, flat_off = phys.reshape(-1), (gpos % page).reshape(-1)
        kp[flat_phys, flat_off] = k.reshape(b * t, heads, dh)
        vp[flat_phys, flat_off] = v.reshape(b * t, heads, dh)
        o = _fa.paged_decode_attention(q, kp, vp, table, pos, conf.causal)
        return project(o), {"k_pages": kp, "v_pages": vp,
                            "page_table": table, "kv_pos": pos + t}

    if cap and "kv_pos" in state:
        pos = state["kv_pos"]
        kc, vc = state["k_cache"], state["v_cache"]
        length = kc.shape[1]
        if isinstance(pos, torch.Tensor):
            # Per-slot cursors: each row lands at its own depth (start
            # clamped so the rows fit, as dynamic_update_slice clamps).
            rows = (pos.long().clamp(0, length - t)[:, None]
                    + torch.arange(t, device=x.device)[None, :])
            bidx = torch.arange(b, device=x.device)[:, None]
            kc[bidx, rows] = k
            vc[bidx, rows] = v
        else:
            s = min(max(int(pos), 0), length - t)
            kc[:, s:s + t] = k
            vc[:, s:s + t] = v
        o = _fa.cached_decode_attention(q, kc, vc, pos, conf.causal)
        return project(o), {"k_cache": kc, "v_cache": vc, "kv_pos": pos + t}

    if mask is not None:
        # Plain PyTorch on every device: the JAX package has no kernel for
        # masked attention either (its masked batch runs on XLA).
        o = _masked_dense_attention(q, k, v, mask, conf.causal, dh ** -0.5)
    else:
        o = _seq.attention(q, k, v, causal=conf.causal, scale=dh ** -0.5,
                           impl=conf.attention_impl)
    new_state = state
    if cap and t <= cap:
        # Prime the decode cache (undeclared state, kept only by the
        # stateful paths). T > cap skips priming so a plain forward still
        # runs on sequences longer than the cache.
        pad = (0, 0, 0, 0, 0, cap - t)
        new_state = {"k_cache": torch.nn.functional.pad(k, pad),
                     "v_cache": torch.nn.functional.pad(v, pad),
                     "kv_pos": t}
    return project(o), new_state
