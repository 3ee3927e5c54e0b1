"""LayerNorm and BatchNorm apply, each + affine + activation (counterpart
of `deeplearning4j_tpu/kernels/norm_act.py`).

`layernorm_norm_act` launches the CUDA kernel of `csrc/norm_act.cu` for a
CUDA tensor (it replaces the TPU kernel `_ln_kernel`, norm_act.py:101; the
source note there says what bounds it and how) and calls `layernorm_plain`,
an op-for-op copy of `layernorm_xla` (norm_act.py:83), for a CPU tensor.
The kernel keeps the statistics in f32 and rounds once at the store, where
the plain version (like JAX) rounds mu and var to the input dtype first, so
the two agree to bf16 rounding in bf16 and to f32 roundoff in f32.

With autograd recording, `layernorm_norm_act` runs through `LayerNormFn`:
the forward is the kernel (the plain version on the CPU) and the backward
the VJP of `layernorm_xla`'s ops recomputed from the saved inputs, as the
JAX package pairs its Pallas forward with the reference VJP
(`_diff.py:19`, norm_act.py:176). That recompute is not a plain call.

`batchnorm_norm_act` is BatchNorm's seam (norm_act.py:140): normalize with
given statistics, affine, activation. For a CUDA tensor it launches the
kernel of `csrc/norm_act.cu` that replaces `_bn_kernel` (norm_act.py:96),
with mean, var, gamma and beta cast to x's dtype as the Pallas path's
`_vec` makes them (norm_act.py:126-129, :158-160); for a CPU tensor it
calls `batchnorm_plain`, `batchnorm_xla` (norm_act.py:75-80) op for op,
where torch promotes as JAX does (a bf16 x with f32 running stats computes
in f32). With autograd recording it runs through `BatchNormFn`, whose
backward is the VJP of the plain ops for all five tensor inputs: the batch
statistics are computed from x inside the differentiated function
(`nn/layers/normalization.py`), so the gradient flows through them too.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build, _diff
from deeplearning4j_tpu_torch.nn import activations

_ACT_CODES = {"identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VECTORS = 8  # 16-byte loads per lane (csrc/norm_act.cu dispatch)
_ACT_BY_KEY = {}  # activation as callers pass it -> its code
# LayerNorm per dtype: (code, elements per 16-byte vector, widest F).
_LN_DTYPES = {dt: (code, 16 // torch.tensor([], dtype=dt).element_size(),
                   32 * (16 // torch.tensor([], dtype=dt).element_size())
                   * _MAX_VECTORS)
              for dt, code in DTYPE_CODES.items()}


def _batchnorm_ops(x, mean, var, gamma, beta, eps, activation):
    """`batchnorm_xla`'s ops (gamma and beta may be floats: the
    `lock_gamma_beta` constants)."""
    xhat = (x - mean) / torch.sqrt(var + eps)
    out = gamma * xhat + beta
    return activations.resolve(activation)(out)


def batchnorm_plain(x, mean, var, gamma, beta, eps, activation):
    """The plain version, as the JAX package's XLA path computes it."""
    kernels.plain_calls["batchnorm_norm_act"].add()
    return _batchnorm_ops(x, mean, var, gamma, beta, eps, activation)


def batchnorm_norm_act(x, mean, var, gamma, beta, eps, activation):
    """act(gamma * (x - mean) / sqrt(var + eps) + beta) over the last axis
    (NHWC channels, or features). x: [..., C]; mean, var, gamma, beta: [C]
    tensors (gamma and beta may be floats). Differentiable through
    `BatchNormFn` in all five."""
    if _diff.needs_grad(*_tensors(x, mean, var, gamma, beta)):
        return BatchNormFn.apply(x, mean, var, gamma, beta, eps, activation)
    return _batchnorm_forward(x, mean, var, gamma, beta, eps, activation)


def _tensors(*args):
    return [a for a in args if isinstance(a, torch.Tensor)]


class BatchNormFn(torch.autograd.Function):
    """Kernel forward (plain version on the CPU), reference-VJP backward
    for x, mean, var, gamma and beta."""

    @staticmethod
    def forward(ctx, x, mean, var, gamma, beta, eps, activation):
        ins = (x, mean, var, gamma, beta)
        ctx.tensor_at = [i for i, a in enumerate(ins)
                         if isinstance(a, torch.Tensor)]
        ctx.consts = tuple(None if isinstance(a, torch.Tensor) else a
                           for a in ins)
        ctx.save_for_backward(*(ins[i] for i in ctx.tensor_at))
        ctx.eps, ctx.activation = eps, activation
        return _batchnorm_forward(x, mean, var, gamma, beta, eps, activation)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors

        def ops(*ts):
            ins = list(ctx.consts)
            for i, t in zip(ctx.tensor_at, ts):
                ins[i] = t
            return _batchnorm_ops(*ins, ctx.eps, ctx.activation)

        got = _diff.ref_vjp(ops, saved,
                            [ctx.needs_input_grad[i] for i in ctx.tensor_at],
                            grad)
        grads = [None] * 5
        for i, g in zip(ctx.tensor_at, got):
            grads[i] = g
        return (*grads, None, None)


def _vec(v, feats, like):
    """mean/var/gamma/beta as a contiguous [feats] vector at x's dtype
    (`_vec`, norm_act.py:126): floats are broadcast."""
    return torch.as_tensor(v, device=like.device).to(like.dtype).broadcast_to(
        (feats,)).contiguous()


def _batchnorm_forward(x, mean, var, gamma, beta, eps, activation):
    if kernels.placement(*_tensors(x, mean, var, gamma, beta)) == "cpu":
        return batchnorm_plain(x, mean, var, gamma, beta, eps, activation)
    _diff.refuse_grad("batchnorm_norm_act",
                      *_tensors(x, mean, var, gamma, beta))
    feats = x.shape[-1]
    act = _act_code(activation)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"batchnorm_norm_act takes float32 or bfloat16, "
                        f"not {x.dtype}")
    vec = 16 // x.element_size()
    if feats % vec:
        raise ValueError(f"the kernel takes a channel count that is a "
                         f"multiple of {vec}; got {feats}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    m, v, g, b = (_vec(a, feats, x) for a in (mean, var, gamma, beta))
    y = torch.empty_like(x)
    rows = x.numel() // feats
    with torch.cuda.device(x.device):
        _build.launch("dl4j_batchnorm_norm_act", x.data_ptr(), m.data_ptr(),
                      v.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                      rows, feats, float(eps), act, DTYPE_CODES[x.dtype],
                      torch.cuda.current_stream(x.device).cuda_stream)
    kernels.launches["batchnorm_norm_act"].add()
    return y


def _act_code(activation) -> int:
    """The kernel's code for `activation`, cached by the value the caller
    passes (a layer passes the same string at every call)."""
    try:
        return _ACT_BY_KEY[activation]
    except (KeyError, TypeError):  # not seen yet, or unhashable
        pass
    act = str(activation or "identity").lower()
    if act not in _ACT_CODES:
        raise ValueError(f"activation {activation!r} is not in the kernel's "
                         f"set {sorted(_ACT_CODES)}")
    try:
        _ACT_BY_KEY[activation] = _ACT_CODES[act]
    except TypeError:
        pass
    return _ACT_CODES[act]


def _layernorm_ops(x, gamma, beta, eps, activation):
    """`layernorm_xla`'s ops: two-pass mean((x - mu)^2) variance."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * gamma + beta
    return activations.resolve(activation)(out)


def layernorm_plain(x, gamma, beta, eps, activation):
    """The plain version, as the JAX package's XLA path computes it."""
    kernels.plain_calls["layernorm_norm_act"].add()
    return _layernorm_ops(x, gamma, beta, eps, activation)


def layernorm_norm_act(x, gamma, beta, eps, activation):
    """Per-row statistics over the last axis, normalize, affine, then
    `activation` (identity/relu/tanh/sigmoid on the card). x: [..., F];
    gamma, beta: [F] of x's dtype. Differentiable through `LayerNormFn`."""
    if _diff.needs_grad(x, gamma, beta):
        return LayerNormFn.apply(x, gamma, beta, eps, activation)
    return _layernorm_forward(x, gamma, beta, eps, activation)


class LayerNormFn(torch.autograd.Function):
    """Kernel forward (plain version on the CPU), reference-VJP backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, activation):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps, ctx.activation = eps, activation
        return _layernorm_forward(x, gamma, beta, eps, activation)

    @staticmethod
    def backward(ctx, grad):
        x, gamma, beta = ctx.saved_tensors
        grads = _diff.ref_vjp(
            lambda a, g, b: _layernorm_ops(a, g, b, ctx.eps, ctx.activation),
            (x, gamma, beta), ctx.needs_input_grad[:3], grad)
        return (*grads, None, None)


def _layernorm_forward(x, gamma, beta, eps, activation):
    """The kernel for CUDA tensors, the plain version for CPU ones. The
    launch path is kept short, since a decode step makes 9 of these calls
    on [slots, F]: device, gradient and shape checks in one pass, the
    device switched only when it is not current, the raw stream handle."""
    idx = x.get_device()
    if not (x.is_cuda and gamma.get_device() == idx
            and beta.get_device() == idx):
        if kernels.placement(x, gamma, beta) == "cpu":  # else it raised
            return layernorm_plain(x, gamma, beta, eps, activation)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        _diff.refuse_grad("layernorm_norm_act", x, gamma, beta)
    act = _act_code(activation)
    dt = x.dtype
    if dt not in _LN_DTYPES:
        raise TypeError(f"layernorm_norm_act takes float32 or bfloat16, "
                        f"not {dt}")
    code, vec, widest = _LN_DTYPES[dt]
    if gamma.dtype != dt or beta.dtype != dt:
        raise TypeError("gamma and beta must have x's dtype")
    feats = x.shape[-1]
    if gamma.shape != (feats,) or beta.shape != (feats,):
        raise ValueError(f"gamma/beta must be [{feats}]")
    if feats % vec or feats > widest:
        raise ValueError(f"the kernel takes a feature width that is a "
                         f"multiple of {vec} and at most {widest}; got "
                         f"{feats}")
    xp, gp, bp = x.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    if ((xp | gp | bp) % 16 or not (x.is_contiguous()
                                    and gamma.is_contiguous()
                                    and beta.is_contiguous())):
        raise ValueError("x, gamma and beta must be contiguous and "
                         "16-byte aligned")
    y = torch.empty_like(x)
    with _build.on_device(idx):
        _build.launch("dl4j_layernorm_norm_act", xp, gp, bp, y.data_ptr(),
                      x.numel() // feats, feats, float(eps), act, code,
                      _build.current_stream(idx))
    kernels.launches["layernorm_norm_act"].add()
    return y
