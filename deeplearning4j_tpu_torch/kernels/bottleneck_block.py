"""The fused ResNet bottleneck block (counterpart of
`deeplearning4j_tpu/kernels/bottleneck_block.py`): conv1x1 (stride) ->
BN + act -> conv3x3 SAME -> BN + act -> conv1x1 -> BN, plus the input or a
projected (conv1x1 stride + BN) shortcut, then act.

`bottleneck_forward` is the seam of `nn/layers/bottleneck.py` (reference
:363). For CUDA tensors it runs the kernels of `csrc/bottleneck_block.cu`,
which replace `_train_body` (:229, batch statistics emitted as f32 side
outputs) and `_infer_body` (:261, running statistics, optional int8
weights); the source note there says what bounds them and how. Each call
counts one in `launches["bottleneck_train"]` or `["bottleneck_infer"]`,
and one in `variant_launches[...]` under the form its convolutions took;
one call is 9 CUDA launches (train, projecting), 7 (train, identity), 5 or
4 (inference), in either form.

The form is a rule on dtypes and widths (`bottleneck_variant`), not a
fallback: bf16 (or f16) x with weights of the same type and Cin, F1 and F3
multiples of 64 (every ResNet-50 block) multiply on the tensor cores
(wgmma, W by TMA, the BatchNorm prologue in registers), bound by the
bf16/f16 rate and the f32 intermediates' bytes; f32, int8 weights (f16 x
with int8 weights: an int8 checkpoint served under mixed_float16) and
other widths keep the f32 CUDA-core GEMM, bound by the 67 TFLOP/s f32
rate. A launch of either form
that fails raises, and an operand that is not contiguous and 16-byte
aligned is refused before any launch.

float64 x (a float64 policy) takes the block's float64 form, its third:
the same three C entries and CUDA-core kernels at dtype code 4, which
instantiate them in double, the raw conv outputs, partial sums, mean and
var included, with float64 weights, or int8 ones dequantized at the load as
`q * scale` in double (the reference dequantizes at the compute dtype).

For CPU tensors it calls `bottleneck_train_plain` or
`bottleneck_infer_plain`, `xla_train` and `xla_infer` (:128-176) op for op:
`F.conv2d` for the convolutions, the single-pass batch statistics, and
BatchNorm through `norm_act`'s plain ops.

The plain versions compute at x's dtype as XLA does (a bf16 conv output is
rounded to bf16 before its statistics); the kernels keep the intermediates
in f32 as the TPU body does (the tensor-core form rounds each conv's
normalized input to bf16 or f16, as the MXU does at default precision), so
the two agree to bf16 (f16) rounding in bf16 (f16). The JAX package sends
f16 to XLA (:64-73), whose ops the plain version copies.

With autograd recording, training runs through `BottleneckFn`: the forward
is the kernel sequence (the plain version on the CPU), the backward the VJP
of the plain composite recomputed from the saved inputs (:433-443,
:471-475), through the batch statistics. The statistics outputs are not
differentiable: they only feed the layer's EMA, which runs on detached
values.

int8 weights (each `W_<branch>` int8 with a `W_<branch>__scale` f32 [F]
sibling) are inference only (training on them raises, :373-376). When every
branch is int8 the kernel dequantizes at the load (`q * scale`, the scale
over the output channel, :197-205); a tree that mixes int8 and float
branches dequantizes them here first, as the reference does (:378-382).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build, _diff
from deeplearning4j_tpu_torch.kernels.norm_act import (
    DTYPE_CODES,
    _act_code,
    _batchnorm_ops,
)
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    conv2d_nhwc,
    same_pads,
)

_BRANCHES = ("a", "b", "c")
_STAT_KEYS = ("mean_a", "var_a", "mean_b", "var_b", "mean_c", "var_c")
_STAT_KEYS_PROJ = _STAT_KEYS + ("mean_proj", "var_proj")
_W_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float16: 3, torch.float64: 4}
# The weights each x dtype takes (a float64 block: float64 or int8 ones).
_W_TAKEN = {torch.float64: (torch.float64, torch.int8)}
_W_TAKEN_LOW = (torch.float32, torch.bfloat16, torch.float16, torch.int8)
_X_CODES = {**DTYPE_CODES, torch.float64: 4}
_BM = 64  # output rows per conv block (csrc/bottleneck_block.cu kBM)


def stat_keys(project: bool) -> Tuple[str, ...]:
    return _STAT_KEYS_PROJ if project else _STAT_KEYS


def _branches(project: bool) -> Tuple[str, ...]:
    return _BRANCHES + (("proj",) if project else ())


# ------------------------------------------------------ plain versions


def _conv(x, w, stride):
    """The reference's `_conv`: SAME, NHWC x, HWIO w cast to x's dtype."""
    k = w.shape[:2]
    pads = (same_pads(x.shape[1], k[0], stride[0]),
            same_pads(x.shape[2], k[1], stride[1]))
    return conv2d_nhwc(x, w.to(x.dtype), stride, pads)


def _bn_stats(x):
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes)
    var = (x * x).mean(dim=axes) - mean * mean
    return mean, var


def _train_ops(x, wa, ga, ba, wb, gb, bb, wc, gc, bc, wp=None, gp=None,
               bp=None, *, stride, eps, act):
    """`xla_train`: (y, stats), stats the flat (mean_a, var_a, ...)."""
    a = _conv(x, wa, stride)
    ma, va = _bn_stats(a)
    a = _batchnorm_ops(a, ma, va, ga, ba, eps, act)
    h = _conv(a, wb, (1, 1))
    mb, vb = _bn_stats(h)
    h = _batchnorm_ops(h, mb, vb, gb, bb, eps, act)
    c = _conv(h, wc, (1, 1))
    mc, vc = _bn_stats(c)
    c = _batchnorm_ops(c, mc, vc, gc, bc, eps, "identity")
    stats = (ma, va, mb, vb, mc, vc)
    if wp is None:
        shortcut = x
    else:
        p = _conv(x, wp, stride)
        mp, vp = _bn_stats(p)
        shortcut = _batchnorm_ops(p, mp, vp, gp, bp, eps, "identity")
        stats = stats + (mp, vp)
    return activations.resolve(act)(c + shortcut), stats


def _infer_ops(x, wa, ga, ba, wb, gb, bb, wc, gc, bc, wp=None, gp=None,
               bp=None, *, stats, stride, eps, act):
    """`xla_infer`: the same chain with the running statistics given."""
    a = _batchnorm_ops(_conv(x, wa, stride), stats["mean_a"],
                       stats["var_a"], ga, ba, eps, act)
    h = _batchnorm_ops(_conv(a, wb, (1, 1)), stats["mean_b"],
                       stats["var_b"], gb, bb, eps, act)
    c = _batchnorm_ops(_conv(h, wc, (1, 1)), stats["mean_c"],
                       stats["var_c"], gc, bc, eps, "identity")
    if wp is None:
        shortcut = x
    else:
        shortcut = _batchnorm_ops(_conv(x, wp, stride), stats["mean_proj"],
                                  stats["var_proj"], gp, bp, eps, "identity")
    return activations.resolve(act)(c + shortcut)


def bottleneck_train_plain(x, *flat, stride, eps, act):
    """The plain version of the training block: (y, stats tuple)."""
    kernels.plain_calls["bottleneck_train"].add()
    return _train_ops(x, *flat, stride=stride, eps=eps, act=act)


def bottleneck_infer_plain(x, *flat, stats, stride, eps, act):
    """The plain version of the inference block: y."""
    kernels.plain_calls["bottleneck_infer"].add()
    return _infer_ops(x, *flat, stats=stats, stride=stride, eps=eps, act=act)


# ------------------------------------------------------------ kernels


def _f32(v):
    return v.detach().to(torch.float32).contiguous()


def _f64(v):
    return v.detach().to(torch.float64).contiguous()


def _f32_all(vs):
    """`_f32` of each of `vs` (1-D), in one cast where any is not f32: a
    bf16 block's 6 or 8 gamma and beta vectors cost one concatenation and
    one conversion instead of a conversion each."""
    if all(v.dtype == torch.float32 and v.is_contiguous() for v in vs):
        return [v.detach() for v in vs]
    flat = torch.cat([v.detach().reshape(-1) for v in vs]).to(torch.float32)
    return list(flat.split([v.numel() for v in vs]))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(*ts):
    for t in ts:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("bottleneck_block: every operand must be "
                             "contiguous and 16-byte aligned")


def _launch_conv(stream, inp, w, wscale, ks, stride, pad, pro, eps, act,
                 with_stats, variant):
    """One implicit-GEMM conv of `inp` (NHWC) with w ([ks*ks*Cin, F] as
    HWIO lies), raw out [B, Ho, Wo, F] (f32; f64 in the float64 form), in
    the form `variant`; `pro` the previous branch's (mean, var, gamma,
    beta) at the out's dtype, or None; returns (out, psum, psq), the
    partial sums when `with_stats`."""
    b, h, wd, c = inp.shape
    n_out = w.shape[-1]
    ho, wo = -(-h // stride[0]), -(-wd // stride[1])
    m = b * ho * wo
    acc = torch.float64 if variant == "f64" else torch.float32
    out = torch.empty((m, n_out), dtype=acc, device=inp.device)
    psum = psq = None
    if with_stats:
        psum = torch.empty((-(-m // _BM), n_out), dtype=acc,
                           device=inp.device)
        psq = torch.empty_like(psum)
    pro = pro if pro is not None else (None,) * 4
    _aligned(inp, w, wscale, *pro)
    _build.launch("dl4j_bottleneck_conv", inp.data_ptr(),
                  _X_CODES[inp.dtype], b, h, wd, c, ho, wo, ks, stride[0],
                  stride[1], pad, *map(_ptr, pro), act, float(eps),
                  w.data_ptr(), _W_CODES[w.dtype], _ptr(wscale), n_out,
                  out.data_ptr(), _ptr(psum), _ptr(psq), _VARIANTS[variant],
                  stream)
    return out.view(b, ho, wo, n_out), psum, psq


def _launch_stats(stream, psum, psq, rows):
    n = psum.shape[1]
    mean = torch.empty(n, dtype=psum.dtype, device=psum.device)
    var = torch.empty_like(mean)
    _build.launch("dl4j_bottleneck_stats", psum.data_ptr(), psq.data_ptr(),
                  psum.shape[0], n, rows, mean.data_ptr(), var.data_ptr(),
                  _X_CODES[psum.dtype], stream)
    return mean, var


def _check(x, ws, stride, project):
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16,
                       torch.float64):
        raise TypeError(f"bottleneck_block takes float32, bfloat16, float16 "
                        f"or float64 activations on the card, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"bottleneck_block takes NHWC x, got {x.shape}")
    cin, f1, f3 = x.shape[3], ws["a"].shape[-1], ws["c"].shape[-1]
    if cin % 4 or f1 % 4 or f3 % 4:
        raise ValueError(f"the kernel takes channel counts that are "
                         f"multiples of 4; got Cin={cin}, F1={f1}, F3={f3}")
    taken = _W_TAKEN.get(x.dtype, _W_TAKEN_LOW)
    for n, w in ws.items():
        if w.dtype not in taken:
            raise TypeError(f"W_{n}: a {x.dtype} block takes weights of "
                            f"{', '.join(map(str, taken))}, not {w.dtype}")
    if not project and (tuple(stride) != (1, 1) or cin != f3):
        raise ValueError("the identity shortcut needs stride 1 and "
                         f"Cin == 4 * filters; got {stride}, Cin={cin}, "
                         f"F3={f3}")


# The three forms of the block's convolutions and their codes in the C
# entry: the float64 form is the CUDA-core one, in double.
_VARIANTS = {"cuda_cores": 0, "wgmma": 1, "f64": 0}


def bottleneck_variant(x_dtype, w_dtype, cin: int, f1: int, f3: int) -> str:
    """Which form of its convolutions a block launches: "f64" (the
    CUDA-core kernels in double) for float64 x, "wgmma" (bf16 or f16
    products on the tensor cores) when x and every W share bf16 or f16
    (`w_dtype` the dtype the W share; None when they differ) and Cin, F1
    and F3 are multiples of 64, else "cuda_cores" (f32 products; f32, int8
    weights, mixed dtypes, other widths). A dispatch by dtype and width, not
    a fallback."""
    if x_dtype == torch.float64:
        return "f64"
    wide = cin % 64 == 0 and f1 % 64 == 0 and f3 % 64 == 0
    return ("wgmma" if x_dtype in (torch.bfloat16, torch.float16)
            and w_dtype == x_dtype and wide else "cuda_cores")


def _kernel_block(x, flat, scales, running, stride, eps, act, train):
    """The kernel sequence on CUDA tensors: flat is (W, gamma, beta) per
    branch; scales {branch: int8 dequant scale} or None; running the
    running statistics (inference). Returns (y, stats tuple or None)."""
    project = len(flat) == 12
    names = _branches(project)
    ws = {n: flat[3 * i].contiguous() for i, n in enumerate(names)}
    _check(x, ws, stride, project)
    _aligned(x)
    act_code = _act_code(act)
    w_dtypes = {w.dtype for w in ws.values()}
    variant = bottleneck_variant(
        x.dtype, w_dtypes.pop() if len(w_dtypes) == 1 else None, x.shape[3],
        ws["a"].shape[-1], ws["c"].shape[-1])
    # The f32 (f64) vectors the conv prologues and the tail read.
    vec = _f64 if variant == "f64" else _f32
    stats = []
    affine = [flat[3 * i + j] for i in range(len(names)) for j in (1, 2)]
    affine = (list(map(vec, affine)) if variant == "f64"
              else _f32_all(affine))

    def branch(i, inp, ks, strd, pad, pro):
        """Conv i of the block; returns its raw output and its BatchNorm's
        (mean, var, gamma, beta) in f32 (f64), batch or running."""
        n = names[i]
        scale = None if scales is None else _f32(scales[n])
        out, psum, psq = _launch_conv(stream, inp, ws[n], scale, ks, strd,
                                      pad, pro, eps, act_code, train,
                                      variant)
        if train:
            mean, var = _launch_stats(stream, psum, psq,
                                      out.numel() // out.shape[-1])
            stats.extend((mean, var))
        else:
            mean, var = vec(running[f"mean_{n}"]), vec(running[f"var_{n}"])
        return out, (mean, var, affine[2 * i], affine[2 * i + 1])

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        a, na = branch(0, x, 1, stride, 0, None)
        h, nb = branch(1, a, 3, (1, 1), 1, na)
        c, nc = branch(2, h, 1, (1, 1), 0, nb)
        p, npj = (branch(3, x, 1, stride, 0, None) if project
                  else (None, (None,) * 4))
        y = torch.empty(c.shape, dtype=x.dtype, device=x.device)
        _aligned(*nc, *npj)
        vectors = (c.data_ptr(), *map(_ptr, nc), _ptr(p), *map(_ptr, npj),
                   x.data_ptr())
        _build.launch("dl4j_bottleneck_tail", *vectors, _X_CODES[x.dtype],
                      c.numel() // c.shape[-1], c.shape[-1], float(eps),
                      act_code, y.data_ptr(), stream)
    name = "bottleneck_train" if train else "bottleneck_infer"
    kernels.launches[name].add()
    kernels.variant_launches[name][variant].add()
    return y, (tuple(stats) if train else None)



# ---------------------------------------------------------- autograd


class BottleneckFn(torch.autograd.Function):
    """Kernel forward (plain version on the CPU), plain-composite VJP
    backward. `spec` = (train, stride, eps, act, running stats or None);
    then x and the flat (W, gamma, beta) per branch. Returns y, then in
    training the batch statistics (not differentiable)."""

    @staticmethod
    def forward(ctx, spec, x, *flat):
        train, stride, eps, act, running = spec
        ctx.spec = spec
        ctx.save_for_backward(x, *flat)
        y, stats = _block_forward(x, flat, train, stride, eps, act, running)
        if not train:
            return y
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, gy, *_stat_grads):
        train, stride, eps, act, running = ctx.spec
        inputs = ctx.saved_tensors

        def ref(xv, *flat):
            if train:
                return _train_ops(xv, *flat, stride=stride, eps=eps,
                                  act=act)[0]
            return _infer_ops(xv, *flat, stats=running, stride=stride,
                              eps=eps, act=act)

        grads = _diff.ref_vjp(ref, inputs, ctx.needs_input_grad[1:], gy)
        return (None, *grads)


def _block_forward(x, flat, train, stride, eps, act, running,
                   scales=None):
    """The block on x's device: the kernel sequence for CUDA tensors, the
    plain version for CPU ones. Returns (y, stats tuple or None)."""
    if kernels.placement(x, *flat) == "cpu":
        if train:
            return bottleneck_train_plain(x, *flat, stride=stride, eps=eps,
                                          act=act)
        if scales is not None:
            flat = list(flat)
            for i, n in enumerate(_branches(len(flat) == 12)):
                flat[3 * i] = _dequant(flat[3 * i], scales[n], x.dtype)
        return bottleneck_infer_plain(x, *flat, stats=running,
                                      stride=stride, eps=eps, act=act), None
    _diff.refuse_grad("bottleneck_block", x, *flat)
    return _kernel_block(x, flat, scales, running, stride, eps, act, train)


def _dequant(q, scale, dtype):
    """The reference's dequant expression (`_dequant`, :347-350)."""
    return q.to(dtype) * scale.to(dtype)


def bottleneck_forward(x, params: Dict[str, torch.Tensor],
                       state: Dict[str, torch.Tensor], *, stride, project,
                       eps, activation, train):
    """`nn/layers/bottleneck.py`'s seam. Returns `(y, stats)`: the batch
    statistics `{mean_a: [F1] ...}` in training, None in inference (the
    EMA stays in the layer)."""
    eps, act = float(eps), str(activation)
    stride = tuple(int(s) for s in stride)
    names = _branches(project)
    qscales = {n: params.get(f"W_{n}__scale") for n in names}
    int8 = all(params[f"W_{n}"].dtype == torch.int8
               and qscales[n] is not None for n in names)
    if train and int8:
        raise ValueError(
            "bottleneck_block: training on int8 weights is unsupported "
            "(quantized checkpoints are inference-only)")
    flat = []
    for n in names:
        w = params[f"W_{n}"]
        if not int8 and w.dtype == torch.int8:
            w = _dequant(w, qscales[n], x.dtype)  # mixed trees
        flat += [w, params[f"gamma_{n}"], params[f"beta_{n}"]]
    if int8:
        # int8 weights carry no gradients: the block runs directly.
        return _block_forward(x, flat, False, stride, eps, act, state,
                              scales=qscales)[0], None
    running = None if train else state
    spec = (bool(train), stride, eps, act, running)
    if _diff.needs_grad(x, *flat):
        out = BottleneckFn.apply(spec, x, *flat)
        if not train:
            return out, None
        y, stats = out[0], out[1:]
    else:
        y, stats = _block_forward(x, flat, train, stride, eps, act, running)
        if not train:
            return y, None
    return y, dict(zip(stat_keys(project), stats))
