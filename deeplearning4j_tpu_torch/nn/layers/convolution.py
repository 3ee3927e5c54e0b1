"""Convolution and pooling (counterpart of
`deeplearning4j_tpu/nn/layers/convolution.py`): `conv2d_apply` (input
dropout or DropConnect on the kernel at train time, `common.py`),
`subsampling_apply` and `lrn_apply` on NHWC activations with HWIO kernels.

The reference's single `lax.conv_general_dilated` becomes `F.conv2d` (a
library convolution outside any TPU kernel, as the JAX package leaves it to
XLA). Activations stay NHWC and kernels HWIO at the boundary; inside, the
NCHW view of an NHWC tensor is PyTorch's `channels_last` layout, so the
convolution reads and writes NHWC memory without a transpose copy.

TF-style SAME padding (`"SAME"` in the reference) is asymmetric: the total
pad is max((ceil(n/s) - 1) * s + k_eff - n, 0), with the smaller half before.
The stem's 7x7 stride-2 conv on 224 pads 2 rows before and 3 after; its 3x3
stride-2 max pool on 112 pads 0 before and 1 after, with -inf. `F.conv2d`'s
and `F.max_pool2d`'s own padding is symmetric and would shift the output, so
an asymmetric pad is applied with `F.pad` first.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.conf.enums import ConvolutionMode, PoolingType
from deeplearning4j_tpu_torch.nn.layers.common import (
    layer_input_dropout,
    maybe_drop_connect,
)


def same_pads(size: int, k: int, s: int, d: int = 1):
    """(before, after) of TF SAME padding along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(mode, padding, h, w, kernel, stride, dilation=(1, 1)):
    """((top, bottom), (left, right)) for the conf's convolution mode."""
    if (ConvolutionMode.of(mode) or ConvolutionMode.TRUNCATE) \
            == ConvolutionMode.SAME:
        return (same_pads(h, kernel[0], stride[0], dilation[0]),
                same_pads(w, kernel[1], stride[1], dilation[1]))
    ph, pw = padding
    return (ph, ph), (pw, pw)


def _pad_nhwc(x, pads, value=0.0):
    (pt, pb), (pl, pr) = pads
    if not (pt or pb or pl or pr):
        return x
    return F.pad(x, (0, 0, pl, pr, pt, pb), value=value)


def _nchw(x):
    """The NCHW view of an NHWC tensor (channels_last strides)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc(x, w, stride, pads, dilation=(1, 1)):
    """x: NHWC [B, H, W, Cin]; w: HWIO [kh, kw, Cin, Cout] -> NHWC
    [B, Ho, Wo, Cout], with the given ((top, bottom), (left, right))."""
    (pt, pb), (pl, pr) = pads
    wt = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if pt == pb and pl == pr:  # symmetric: the convolution pads
        y = F.conv2d(_nchw(x), wt, stride=tuple(stride), padding=(pt, pl),
                     dilation=tuple(dilation))
    else:
        y = F.conv2d(_nchw(_pad_nhwc(x, pads)), wt, stride=tuple(stride),
                     dilation=tuple(dilation))
    return _nhwc(y)


def conv2d_apply(conf, params, state, x, train=False, mask=None, rng=None):
    x = layer_input_dropout(conf, x, rng, train)
    # DropConnect on the compute-dtype kernel, then the cast to x's dtype,
    # in the reference's order (convolution.py:37).
    w = maybe_drop_connect(conf, params["W"], rng, train)
    pads = _pads(conf.convolution_mode, conf.padding, x.shape[1], x.shape[2],
                 w.shape[:2], conf.stride, conf.dilation)
    out = conv2d_nhwc(x, w.to(x.dtype), conf.stride, pads, conf.dilation)
    if "b" in params:
        out = out + params["b"].to(out.dtype)
    return activations.resolve(conf.activation)(out), state


def subsampling_apply(conf, params, state, x, train=False, mask=None,
                      rng=None):
    ptype = PoolingType.of(conf.pooling_type) or PoolingType.MAX
    kernel, stride = tuple(conf.kernel_size), tuple(conf.stride)
    pads = _pads(conf.convolution_mode, conf.padding, x.shape[1], x.shape[2],
                 kernel, stride)
    if ptype == PoolingType.MAX:
        # Pads are -inf, as the reference's reduce_window init value.
        y = F.max_pool2d(_nchw(_pad_nhwc(x, pads, -math.inf)), kernel, stride)
    elif ptype in (PoolingType.AVG, PoolingType.SUM):
        # Zero pads counted in the divisor (reduce_window sum / (kh * kw)).
        y = F.avg_pool2d(_nchw(_pad_nhwc(x, pads)), kernel, stride)
        if ptype == PoolingType.SUM:
            y = y * (kernel[0] * kernel[1])
    elif ptype == PoolingType.PNORM:
        p = float(conf.pnorm)
        y = (F.avg_pool2d(_nchw(_pad_nhwc(x.abs() ** p, pads)), kernel, stride)
             * (kernel[0] * kernel[1])) ** (1.0 / p)
    else:
        raise ValueError(f"Unsupported pooling type: {conf.pooling_type}")
    return _nhwc(y), state


def lrn_apply(conf, params, state, x, train=False, mask=None, rng=None):
    """Cross-channel local response normalization (reference `lrn_apply`,
    convolution.py:83-95): x / (k + alpha * S)^beta, S the sum of x^2 over
    a window of n channels (the last axis), zero-padded (n // 2, (n - 1) //
    2). Alpha is NOT divided by n, and the window pads as the reference's
    reduce_window does, so this is not `F.local_response_norm`. Plain
    PyTorch in x's dtype: the JAX package has no kernel for it either."""
    n = int(conf.n)
    sq = F.pad(x * x, ((n // 2), (n - 1) // 2))
    c = x.shape[-1]
    window = sq[..., 0:c]
    for j in range(1, n):
        window = window + sq[..., j:j + c]
    return x / (conf.k + conf.alpha * window) ** conf.beta, state
