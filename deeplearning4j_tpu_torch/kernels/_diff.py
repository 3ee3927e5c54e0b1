"""Autograd seam for the port's kernels (counterpart of
`deeplearning4j_tpu/kernels/_diff.py`).

A kernel launched through ctypes writes into a `torch.empty` output that
autograd knows nothing of: called in training, it would hand every weight
below it a zero gradient and raise nothing. So a training call goes
through a `torch.autograd.Function`, and a kernel wrapper asked for a
gradient outside one raises (`refuse_grad`).

Flash attention hand-writes its backward (`FlashAttentionFn`). The simpler
forward-only kernels (LayerNorm, BatchNorm, the bottleneck block, the LSTM
cell) pair their forward with the VJP of their reference ops (`ref_vjp`),
as the JAX package's `pallas_fwd_ref_bwd` does: the
backward recomputes the reference forward from the saved inputs and pulls
the incoming gradient through it, so the gradient math is exactly the
reference's and the forward value comes from the kernel.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def needs_grad(*tensors) -> bool:
    """True when autograd is recording and any of `tensors` requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel's output would silently cut the gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel's output carries no gradient, and an "
            "input requires one; call it through its autograd Function (the "
            "public wrappers do) or under torch.no_grad()")


def ref_vjp(ref_fn: Callable, inputs: Sequence[torch.Tensor],
            needs: Sequence[bool], grad_out):
    """Gradients of `ref_fn(*inputs)` against `grad_out` (a tensor, or a
    tuple with one per output when `ref_fn` returns a tuple) for the inputs
    flagged in `needs` (None for the others), by recomputing `ref_fn` on
    detached copies under autograd."""
    with torch.enable_grad():
        xs = [a.detach().requires_grad_(bool(n)) for a, n in zip(inputs, needs)]
        out = ref_fn(*xs)
        wanted = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out)
                     if wanted else ())
    return tuple(next(grads) if n else None for n in needs)
