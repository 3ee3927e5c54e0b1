"""LayerNorm and BatchNorm apply, each + affine + activation (counterpart
of `deeplearning4j_tpu/kernels/norm_act.py`).

`layernorm_norm_act` launches the CUDA kernel of `csrc/norm_act.cu` for a
CUDA tensor (it replaces the TPU kernel `_ln_kernel`, norm_act.py:101; the
source note there says what bounds it and how) and calls `layernorm_plain`,
an op-for-op copy of `layernorm_xla` (norm_act.py:83), for a CPU tensor.
The kernel keeps the statistics in f32 and rounds once at the store, where
the plain version (like JAX) rounds mu and var to the input dtype first, so
the two agree to bf16 (f16) rounding in bf16 (f16) and to f32 roundoff in
f32. The kernel takes f32, bf16 and f16 (the JAX package sends f16 to XLA,
whose ops the plain version copies), at any width F, as the JAX package
does.

With autograd recording, `layernorm_norm_act` runs through `LayerNormFn`:
the forward is the kernel (the plain version on the CPU) and the backward
the VJP of `layernorm_xla`'s ops recomputed from the saved inputs, as the
JAX package pairs its Pallas forward with the reference VJP
(`_diff.py:19`, norm_act.py:176). That recompute is not a plain call.

`batchnorm_norm_act` is BatchNorm's seam (norm_act.py:140): normalize with
given statistics, affine, activation. For a CUDA tensor it launches the
kernel of `csrc/norm_act.cu` that replaces `_bn_kernel` (norm_act.py:96),
at any channel count, in one launch that takes mean, var, gamma and beta
as they come (f32, bf16 or f16 tensors, or floats) and rounds them to x's
dtype in registers as the Pallas path's `_vec` makes them
(norm_act.py:126-129, :158-160), or, for an f16 x (which the JAX package
sends to XLA, :38-44), keeps them in f32: an f16 BatchNorm rounds only y;
for a CPU tensor it calls `batchnorm_plain`, `batchnorm_xla`
(norm_act.py:75-80) op for op, where torch promotes as JAX does (a bf16 x
with f32 running stats computes in f32). With autograd recording it runs
through `BatchNormFn`, whose backward is the VJP of the plain ops for all
five tensor inputs: the batch statistics are computed from x inside the
differentiated function (`nn/layers/normalization.py`), so the gradient
flows through them too.

Both take float64 on the card too, in forms of their own that compute in
double (`dl4j_layernorm_norm_act_f64`, `dl4j_batchnorm_norm_act_f64`:
the gradient checks of float64 nets run them), each launch counted also in
`kernels.variant_launches[name]["f64"]`. A float64 BatchNorm takes its
four vectors as float64 tensors ([C] or 0-d) or floats.
"""

from __future__ import annotations

import numbers

import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build, _diff
from deeplearning4j_tpu_torch.nn import activations

_ACT_CODES = {"identity": 0, "relu": 1, "tanh": 2, "sigmoid": 3}
# csrc/common.cuh's dtype codes (2 is int8, the bottleneck's weights).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}
_ACT_BY_KEY = {}  # activation as callers pass it -> its code
# How a BatchNorm vector reaches the C entry besides its dtype code
# (csrc/norm_act.cu `kBroadcast`, `kByValue`).
_BROADCAST, _BY_VALUE = 4, 8


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
    if torch.is_grad_enabled() and _any_requires_grad(x, mean, var, gamma,
                                                      beta):
        return BatchNormFn.apply(x, mean, var, gamma, beta, eps, activation)
    return _batchnorm_forward(x, mean, var, gamma, beta, eps, activation)


def _tensors(*args):
    return [a for a in args if isinstance(a, torch.Tensor)]


def _any_requires_grad(*args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.requires_grad:
            return True
    return False


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


def _vector_arg(a, feats, idx, name):
    """(pointer, kind, value) of one of mean, var, gamma and beta as the C
    entry takes it (csrc/norm_act.cu `BnVectors`): a contiguous [feats]
    tensor on card `idx` by its own pointer and dtype code, a 0-d tensor
    there by its pointer and code + 4 (read at every channel), a real
    number by value (kind 8). Nothing is copied or cast."""
    if isinstance(a, torch.Tensor):
        code = DTYPE_CODES.get(a.dtype)
        if code is None:
            raise TypeError(f"batchnorm_norm_act: {name} must be float32, "
                            f"bfloat16 or float16 on the card, not {a.dtype}")
        if a.get_device() != idx:
            raise ValueError(f"tensors on different devices: x on cuda:"
                             f"{idx} and {name} on {a.device}")
        if a.dim() == 0:
            return a.data_ptr(), code | _BROADCAST, 0.0
        if a.shape != (feats,) or not a.is_contiguous():
            raise ValueError(f"batchnorm_norm_act: {name} must be a "
                             f"contiguous [{feats}] tensor, a 0-d tensor or "
                             f"a float; got {tuple(a.shape)}")
        return a.data_ptr(), code, 0.0
    if isinstance(a, numbers.Real) and not isinstance(a, bool):
        return 0, _BY_VALUE, float(a)
    raise TypeError(f"batchnorm_norm_act: {name} must be a tensor or a "
                    f"float, not {type(a).__name__}")


def _batchnorm_forward(x, mean, var, gamma, beta, eps, activation):
    """The kernel for CUDA tensors, the plain version for CPU ones. One
    launch a call and no other work on the card: the four vectors go to
    the kernel as they are (`_vector_arg`), and the kernel rounds them in
    registers as the Pallas path's `_vec` does (norm_act.py:126-129). The
    launch path is kept short (ResNet-50's per-layer graph makes 53 of
    these calls a forward): the checks in one pass, the device switched
    only when it is not current, the raw stream handle."""
    if not x.is_cuda:
        if kernels.placement(*_tensors(x, mean, var, gamma, beta)) == "cpu":
            return batchnorm_plain(x, mean, var, gamma, beta, eps,
                                   activation)  # else placement raised
    if torch.is_grad_enabled() and _any_requires_grad(x, mean, var, gamma,
                                                      beta):
        _diff.refuse_grad("batchnorm_norm_act",
                          *_tensors(x, mean, var, gamma, beta))
    if x.dtype == torch.float64:
        return _batchnorm_f64(x, mean, var, gamma, beta, eps, activation)
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"batchnorm_norm_act takes float32, bfloat16, "
                        f"float16 or float64 on the card, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    idx = x.get_device()
    feats = x.shape[-1]
    act = _act_code(activation)
    pm, km, vm = _vector_arg(mean, feats, idx, "mean")
    pv, kv, vv = _vector_arg(var, feats, idx, "var")
    pg, kg, vg = _vector_arg(gamma, feats, idx, "gamma")
    pb, kb, vb = _vector_arg(beta, feats, idx, "beta")
    y = torch.empty_like(x)
    with _build.on_device(idx):
        _build.launch("dl4j_batchnorm_norm_act", x.data_ptr(), pm, pv, pg,
                      pb, y.data_ptr(), x.numel() // feats if feats else 0,
                      feats, float(eps), act, code,
                      km | kv << 4 | kg << 8 | kb << 12, vm, vv, vg, vb,
                      _build.current_stream(idx))
    kernels.launches["batchnorm_norm_act"].add()
    return y


def _f64_vector(a, feats, idx, name):
    """(pointer, kind, value) of a float64 BatchNorm vector: a [feats] or
    0-d float64 tensor on card `idx`, or a real number by value."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.float64:
            raise TypeError(f"batchnorm_norm_act: a float64 x takes float64 "
                            f"vectors; {name} is {a.dtype}")
        if a.get_device() != idx:
            raise ValueError(f"tensors on different devices: x on cuda:"
                             f"{idx} and {name} on {a.device}")
        if a.dim() == 0:
            return a.data_ptr(), _BROADCAST, 0.0
        if a.shape != (feats,) or not a.is_contiguous():
            raise ValueError(f"batchnorm_norm_act: {name} must be a "
                             f"contiguous [{feats}] tensor, a 0-d tensor or "
                             f"a float; got {tuple(a.shape)}")
        return a.data_ptr(), 0, 0.0
    if isinstance(a, numbers.Real) and not isinstance(a, bool):
        return None, _BY_VALUE, float(a)
    raise TypeError(f"batchnorm_norm_act: {name} must be a tensor or a "
                    f"float, not {type(a).__name__}")


def _batchnorm_f64(x, mean, var, gamma, beta, eps, activation):
    """The float64 form: one launch, eps as a double."""
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    idx = x.get_device()
    feats = x.shape[-1]
    act = _act_code(activation)
    vecs = [_f64_vector(a, feats, idx, n) for a, n in (
        (mean, "mean"), (var, "var"), (gamma, "gamma"), (beta, "beta"))]
    y = torch.empty_like(x)
    kinds = 0
    for i, (_, kind, _) in enumerate(vecs):
        kinds |= kind << (4 * i)
    with _build.on_device(idx):
        _build.launch("dl4j_batchnorm_norm_act_f64", x.data_ptr(),
                      *(p for p, _, _ in vecs), y.data_ptr(),
                      x.numel() // feats if feats else 0, feats, float(eps),
                      act, kinds, *(v for _, _, v in vecs),
                      _build.current_stream(idx))
    kernels.launches["batchnorm_norm_act"].add()
    kernels.variant_launches["batchnorm_norm_act"]["f64"].add()
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
    device switched only when it is not current, the raw stream handle.
    Any width F: the C entry picks the form (csrc/norm_act.cu `launch`)."""
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
    code = DTYPE_CODES.get(dt)
    if code is None and dt != torch.float64:
        raise TypeError(f"layernorm_norm_act takes float32, bfloat16, "
                        f"float16 or float64, not {dt}")
    if gamma.dtype != dt or beta.dtype != dt:
        raise TypeError("gamma and beta must have x's dtype")
    feats = x.shape[-1]
    if gamma.shape != (feats,) or beta.shape != (feats,):
        raise ValueError(f"gamma/beta must be [{feats}]")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("x, gamma and beta must be contiguous")
    xp, gp, bp = x.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    y = torch.empty_like(x)
    rows = x.numel() // feats if feats else 0
    with _build.on_device(idx):
        if code is None:  # float64
            _build.launch("dl4j_layernorm_norm_act_f64", xp, gp, bp,
                          y.data_ptr(), rows, feats, float(eps), act,
                          _build.current_stream(idx))
            kernels.variant_launches["layernorm_norm_act"]["f64"].add()
        else:
            _build.launch("dl4j_layernorm_norm_act", xp, gp, bp,
                          y.data_ptr(), rows, feats, float(eps), act, code,
                          _build.current_stream(idx))
    kernels.launches["layernorm_norm_act"].add()
    return y
