"""The framework's attention entry (counterpart of
`deeplearning4j_tpu/parallel/sequence.py:173`).

`attention(impl="auto")` is flash attention (`kernels/flash_attention.py`:
the resident kernels, or the streamed ones once the K/V of one (batch,
head) outgrow the resident limit); `impl="dense"` the dense path, which
holds the [T, T] scores. Ring and Ulysses attention shard the sequence over
several cards and are not ported (ROADMAP A.13): they are refused.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.kernels import flash_attention as _fa

IMPLS = ("auto", "dense")


def attention(q, k, v, *, causal: bool = True,
              scale: Optional[float] = None, impl: str = "auto"):
    """Single-device multi-head attention, q/k/v [B, T, H, Dh] ->
    [B, T, H, Dh]."""
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, scale=scale)
    if impl != "auto":
        raise ValueError(
            f"attention impl {impl!r} is not in the port: it runs 'auto' "
            "(flash) and 'dense'; ring and Ulysses sequence parallelism "
            "need several cards (ROADMAP A.13)")
    return _fa.flash_attention(q, k, v, causal, scale)


def dense_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """Single-device reference: q/k/v [B, T, H, Dh] -> [B, T, H, Dh] through
    a materialized [T, T] softmax, differentiable by autograd."""
    return _fa.dense(q, k, v, causal, scale)
