"""Fused optimizer update (counterpart of
`deeplearning4j_tpu/kernels/fused_update.py`).

`dispatch(kind, state, grads, lr, step, hyper)` is `ops/updaters.py`'s seam
for `adam`, `nesterovs` and `rmsprop`, with the JAX contract: `state` is
the kind's fields (`{"m": {name: t}, "v": {...}}`, `{"v": ...}`,
`{"g2": ...}`) over one layer's params, `grads` is `{name: t}`, and it
returns `(new_state, deltas)`, the caller subtracting the deltas.

- CUDA tensors: one launch of the kernel of `csrc/fused_update.cu`
  (replacing `_adam_kernel`, `_nesterovs_kernel`, `_rmsprop_kernel`,
  fused_update.py:109,121,129) over the layer's f32 tensors as they lie,
  in sorted-name order (`ravel_pytree`'s). The state is updated IN PLACE:
  `new_state` holds the same tensors, and the old values are gone.
- CPU tensors: the plain versions `adam_xla`, `nesterovs_xla`,
  `rmsprop_xla`, the JAX package's XLA bodies (fused_update.py:77-103)
  transcribed op for op; they return new tensors.

Both take lr, bc1 = 1 - beta1^t and bc2 = 1 - beta2^t as f32 values,
computed on the host in f32 as `_scalars` (fused_update.py:159) does, with
t = step + 1 and `step` the iteration before it is counted.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build

KINDS = ("adam", "nesterovs", "rmsprop")
FIELDS = {"adam": ("m", "v"), "nesterovs": ("v",), "rmsprop": ("g2",)}
_KIND_CODES = {"adam": 0, "nesterovs": 1, "rmsprop": 2}
_MAX_TENSORS = 16  # csrc/fused_update.cu kMaxTensors


def scalars(lr, step, kind, hyper):
    """(lr, bc1, bc2) as f32, as the reference's `_scalars` computes them."""
    lr32 = np.float32(lr)
    if kind != "adam":
        return lr32, lr32, lr32
    beta1, beta2, _ = hyper
    t = np.float32(step) + np.float32(1.0)
    one = np.float32(1.0)
    return (lr32, one - np.float32(beta1) ** t, one - np.float32(beta2) ** t)


def adam_xla(state, grads, lr, step, beta1, beta2, eps):
    lr, bc1, bc2 = (float(a) for a in scalars(lr, step, "adam",
                                              (beta1, beta2, eps)))
    m = {k: beta1 * state["m"][k] + (1 - beta1) * g for k, g in grads.items()}
    v = {k: beta2 * state["v"][k] + (1 - beta2) * g * g
         for k, g in grads.items()}
    deltas = {k: lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
              for k in grads}
    return {"m": m, "v": v}, deltas


def nesterovs_xla(state, grads, lr, step, momentum):
    lr = float(np.float32(lr))
    v_prev = state["v"]
    v = {k: momentum * v_prev[k] - lr * g for k, g in grads.items()}
    # ND4J semantics: applied update = -(mu*vPrev) + (1+mu)*v, negated
    # because the caller subtracts deltas.
    deltas = {k: momentum * v_prev[k] - (1.0 + momentum) * v[k]
              for k in grads}
    return {"v": v}, deltas


def rmsprop_xla(state, grads, lr, step, decay, eps):
    lr = float(np.float32(lr))
    g2 = {k: decay * state["g2"][k] + (1 - decay) * g * g
          for k, g in grads.items()}
    deltas = {k: lr * g / torch.sqrt(g2[k] + eps) for k, g in grads.items()}
    return {"g2": g2}, deltas


_PLAIN = {"adam": adam_xla, "nesterovs": nesterovs_xla,
          "rmsprop": rmsprop_xla}


def _kernel_scalars(kind, lr, step, hyper):
    """The kernel's 8 floats: lr, bc1, bc2, then the kind's constants with
    each (1 - x) computed in double and rounded once, as the reference's
    Python-float constants are."""
    lr32, bc1, bc2 = scalars(lr, step, kind, hyper)
    if kind == "adam":
        b1, b2, eps = hyper
        rest = (b1, 1 - b1, b2, 1 - b2, eps)
    elif kind == "nesterovs":
        (mom,) = hyper
        rest = (mom, 1.0 + mom)
    else:
        decay, eps = hyper
        rest = (decay, 1 - decay, eps)
    vals = [float(lr32), float(bc1), float(bc2), *rest]
    return (ctypes.c_float * 8)(*(vals + [0.0] * (8 - len(vals))))


def _launch(kind, state, grads, lr, step, hyper):
    names = sorted(grads)
    fields = FIELDS[kind]
    deltas = {k: torch.empty_like(g) for k, g in grads.items()}
    for k in names:
        ts = [grads[k]] + [state[f][k] for f in fields]
        for t in ts:
            if t.dtype != torch.float32:
                raise TypeError(f"fused_update takes float32 state and "
                                f"grads; {k!r} has {t.dtype}")
            if not t.is_contiguous() or t.shape != grads[k].shape:
                raise ValueError(f"fused_update: {k!r} state and grad must "
                                 "be contiguous and of one shape")
    sc = _kernel_scalars(kind, lr, step, hyper)
    dev = grads[names[0]].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i in range(0, len(names), _MAX_TENSORS):
            chunk = names[i:i + _MAX_TENSORS]
            s1 = [state["v"][k].data_ptr() for k in chunk] if kind == "adam" \
                else [None] * len(chunk)
            ptrs = ([state[fields[0]][k].data_ptr() for k in chunk] + s1
                    + [grads[k].data_ptr() for k in chunk]
                    + [deltas[k].data_ptr() for k in chunk])
            parr = (ctypes.c_void_p * len(ptrs))(*ptrs)
            sizes = (ctypes.c_int64 * len(chunk))(
                *[grads[k].numel() for k in chunk])
            _build.launch("dl4j_fused_update", _KIND_CODES[kind], len(chunk),
                          ctypes.addressof(parr), ctypes.addressof(sizes),
                          ctypes.addressof(sc), stream)
            kernels.launches["fused_update"].add()
    return state, deltas


def dispatch(kind, state, grads, lr, step, hyper):
    """`ops/updaters.py`'s seam: `hyper` is the positional hyperparameter
    tuple of the kind's plain version; `lr` a host float, `step` the host
    iteration count. Returns `(new_state, deltas)`."""
    if kind not in KINDS:
        raise ValueError(f"fused_update has no {kind!r} body; it has {KINDS}")
    if not grads:
        return state, {}
    tensors = [*grads.values(),
               *(t for f in FIELDS[kind] for t in state[f].values())]
    if kernels.placement(*tensors) == "cpu":
        kernels.plain_calls["fused_update"].add()
        return _PLAIN[kind](state, grads, lr, step, *hyper)
    return _launch(kind, state, grads, lr, step, hyper)
