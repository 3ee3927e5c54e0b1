"""One LSTM step: recurrent product, gates, peepholes and mask (counterpart
of `deeplearning4j_tpu/kernels/lstm_cell.py`).

`lstm_cell(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation, activation)`
returns `(h, c, out)` for one time step of one layer. `pW` is the layer's
flat `[3n]` peephole vector (rows p_i, p_f, p_o) or None; `m_t` a `[b]`
step mask at x's dtype or None.

- A CUDA tensor launches the kernel of `csrc/lstm_cell.cu`, which replaces
  the TPU kernel `_cell_kernel` (lstm_cell.py:119, reached through
  `pallas_cell` :182 and `resolve_cell` :199): the recurrent product is the
  kernel's own (accumulated in f32, as `preferred_element_type` does), the
  gates run in registers, and h, c and out are stored in the operand dtype
  (without a mask out is h itself, as in the plain version). It takes
  f32, bf16, f16 and f64 (the f64 form sums and activates in double: the
  gradient checks run it), and every elementwise activation of
  `nn/activations.py` (16 names, `ACT_CODES`) as the gate activation and
  as the cell activation, where the TPU kernel takes sigmoid gates and
  four cell activations (`_CELL_ACTS` :37) and sends the rest to XLA.
- Softmax, which reduces across the hidden units that the kernel spreads
  over its blocks, takes two launches: the kernel in its "z out" form
  (the product and the input-side peepholes, written to a [b, 4n] f32
  workspace, f64 for f64), then `lstm_cell_rows`, a kernel that takes a
  row a block and does the gate math with each softmax over its gate's n
  units, as `xla_cell` applies it after `jnp.split(z, 4)`. The first
  counts in `launches["lstm_cell"]` and `variant_launches["lstm_cell"]
  ["zout"]`, the second in `launches["lstm_cell_rows"]`.
- A gate or cell activation that is the user's (a callable, or a name
  given to `activations.register`) cannot run in a hand-written kernel:
  such a cell runs the "z out" launch on the card and its gate math as
  torch ops that call the user's function on the card tensors, counted in
  `variant_launches["lstm_cell"]["callable"]`. That tail is the user's
  code, not a plain version standing in for a kernel; a built-in name
  never takes it. An unknown name raises ValueError, as `resolve` does.
- A CPU tensor calls `lstm_cell_plain`, `xla_cell` (:86) transcribed op for
  op, with `_lstm_scan`'s split of pW (recurrent.py:48). In bf16 it rounds
  z = xw_t + h_prev @ RW to bf16, as XLA does, where the kernel keeps z in
  f32: a bf16 kernel is held to the plain version run in f32 on the same
  inputs.

With autograd recording, `lstm_cell` runs through `LSTMCellFn`: the forward
is the kernel (the plain version on the CPU), the backward the VJP of the
plain ops recomputed from the saved inputs, as the JAX package pairs its
Pallas cell with `xla_cell`'s VJP (`_diff.pallas_fwd_ref_bwd`, :217). There
is no backward kernel, as there is none in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build, _diff
from deeplearning4j_tpu_torch.nn import activations

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3,
               torch.float64: 4}
SOFTMAX_CODE = 16  # csrc/lstm_cell.cu `kSoftmax`, `lstm_rows_kernel` only
# The kernel's activation codes (csrc/lstm_cell.cu `cell_act`): every
# elementwise name of nn/activations.py, as a gate and as the cell
# activation.
ACT_CODES = {name: i for i, name in enumerate((
    "identity", "relu", "tanh", "sigmoid", "leakyrelu", "elu", "cube",
    "softplus", "softsign", "rationaltanh", "rectifiedtanh", "hardsigmoid",
    "hardtanh", "selu", "gelu", "swish"))}


def _cell_ops(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
              activation):
    """`xla_cell`'s ops, in its order (`_lstm_scan` splits pW)."""
    n = h_prev.shape[-1]
    z = xw_t + h_prev @ RW
    zi, zf, zo, zg = torch.split(z, n, dim=-1)
    if pW is not None:
        zi = zi + c_prev * pW[:n]
        zf = zf + c_prev * pW[n:2 * n]
    return _cell_tail(zi, zf, zo, zg, h_prev, c_prev, pW, m_t,
                      gate_activation, activation)


def _cell_tail(zi, zf, zo, zg, h_prev, c_prev, pW, m_t, gate_activation,
               activation):
    """`xla_cell`'s gate math from z (input-side peepholes added)."""
    gate_act = activations.resolve(gate_activation)
    cell_act = activations.resolve(activation)
    n = h_prev.shape[-1]
    i = gate_act(zi)
    f = gate_act(zf)
    g = cell_act(zg)
    c = f * c_prev + i * g
    if pW is not None:
        zo = zo + c * pW[2 * n:]
    o = gate_act(zo)
    h = o * cell_act(c)
    if m_t is not None:
        m = m_t[:, None]
        h = m * h + (1.0 - m) * h_prev
        c = m * c + (1.0 - m) * c_prev
        out = m * h
    else:
        out = h
    return h, c, out


def lstm_cell_plain(xw_t, h_prev, c_prev, RW, pW, m_t,
                    gate_activation="sigmoid", activation="tanh"):
    """The plain version, as the JAX package's XLA scan body computes it."""
    kernels.plain_calls["lstm_cell"].add()
    return _cell_ops(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
                     activation)


def lstm_cell(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation="sigmoid",
              activation="tanh"):
    """One step: xw_t [b, 4n] (x @ W + b at this step; rows may be strided),
    h_prev, c_prev [b, n], RW [n, 4n], pW [3n] or None, m_t [b] or None.
    Returns (h, c, out), each [b, n]. Differentiable through `LSTMCellFn`
    in xw_t, h_prev, c_prev, RW and pW."""
    if torch.is_grad_enabled() and (
            xw_t.requires_grad or h_prev.requires_grad
            or c_prev.requires_grad or RW.requires_grad
            or (pW is not None and pW.requires_grad)):
        return LSTMCellFn.apply(xw_t, h_prev, c_prev, RW, pW, m_t,
                                gate_activation, activation)
    # No input but the mask can require a gradient here.
    run = _cell_run if m_t is None else _cell_forward
    return run(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
               activation)


def _tensors(*args):
    return [a for a in args if a is not None]


class LSTMCellFn(torch.autograd.Function):
    """Kernel forward (plain version on the CPU), reference-VJP backward."""

    @staticmethod
    def forward(ctx, xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
                activation):
        ctx.save_for_backward(xw_t, h_prev, c_prev, RW, pW, m_t)
        ctx.acts = (gate_activation, activation)
        return _cell_forward(xw_t, h_prev, c_prev, RW, pW, m_t,
                             gate_activation, activation)

    @staticmethod
    def backward(ctx, grad_h, grad_c, grad_out):
        xw_t, h_prev, c_prev, RW, pW, m_t = ctx.saved_tensors
        peep = pW is not None
        ins = (xw_t, h_prev, c_prev, RW) + ((pW,) if peep else ())

        def ops(*a):
            return _cell_ops(*a[:4], a[4] if peep else None, m_t, *ctx.acts)

        grads = _diff.ref_vjp(ops, ins, ctx.needs_input_grad[:len(ins)],
                              (grad_h, grad_c, grad_out))
        return (*grads[:4], grads[4] if peep else None, None, None, None)


def _cell_forward(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
                  activation):
    """The kernel for CUDA tensors, the plain version for CPU ones; a
    CUDA call whose input requires a gradient under autograd raises (the
    output would cut it: `LSTMCellFn` is the way)."""
    if torch.is_grad_enabled() and h_prev.get_device() >= 0 and (
            xw_t.requires_grad or h_prev.requires_grad
            or c_prev.requires_grad or RW.requires_grad
            or (pW is not None and pW.requires_grad)
            or (m_t is not None and m_t.requires_grad)):
        _diff.refuse_grad("lstm_cell", *_tensors(xw_t, h_prev, c_prev, RW,
                                                 pW, m_t))
    return _cell_run(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
                     activation)


class _CellParams(ctypes.Structure):
    """The kernel's scalars (csrc/lstm_cell.cu `CellParams`), built once
    per shape and handed over by address."""
    _fields_ = [("xw_stride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in ("b", "n", "act", "gate", "dtype",
                                          "zout")]


# (shapes, dtypes, xw_t's row stride, activations, device index) of a call
# whose checks passed -> (_CellParams, its address).
_launches = {}


def _cell_run(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation,
              activation):
    """One step on the card, or the plain version for CPU tensors. The
    launch path is kept short, since the scan makes one call per step and
    layer: the checks that depend on shapes, dtypes and activations run
    once per shape (`_setup`), only the layout is checked each call, and
    the scalars go over as one block."""
    idx = h_prev.get_device()
    if not (idx >= 0 and xw_t.get_device() == idx
            and c_prev.get_device() == idx and RW.get_device() == idx
            and (pW is None or pW.get_device() == idx)
            and (m_t is None or m_t.get_device() == idx)):
        ts = _tensors(xw_t, h_prev, c_prev, RW, pW, m_t)
        if kernels.placement(*ts) == "cpu":  # else it raised
            return lstm_cell_plain(xw_t, h_prev, c_prev, RW, pW, m_t,
                                   gate_activation, activation)
    if m_t is not None:
        m_t = m_t.to(xw_t.dtype).contiguous()
    key = (xw_t.shape, xw_t.stride(0), h_prev.shape, c_prev.shape, RW.shape,
           xw_t.dtype, h_prev.dtype, c_prev.dtype, RW.dtype,
           None if pW is None else (pW.shape, pW.dtype),
           None if m_t is None else m_t.shape, gate_activation, activation,
           idx)
    setup = _launches.get(key)
    if setup is None:
        setup = _launches[key] = _setup(xw_t, h_prev, c_prev, RW, pW, m_t,
                                        gate_activation, activation)
    if not (h_prev.is_contiguous() and c_prev.is_contiguous()
            and RW.is_contiguous() and xw_t.stride(1) == 1
            and (pW is None or pW.is_contiguous())):
        _refuse(xw_t, h_prev, c_prev, RW, pW, m_t)
    route, params, rows_params = setup[0], setup[2], setup[4]
    f64 = xw_t.dtype == torch.float64
    stream = _build.current_stream(idx)
    pw_ptr = None if pW is None else pW.data_ptr()
    if route == "cell":
        h, c = torch.empty_like(h_prev), torch.empty_like(h_prev)
        out = h if m_t is None else torch.empty_like(h_prev)  # as plain ops
        with _build.on_device(idx):
            _build.launch(
                "dl4j_lstm_cell", xw_t.data_ptr(), h_prev.data_ptr(),
                c_prev.data_ptr(), RW.data_ptr(), pw_ptr,
                None if m_t is None else m_t.data_ptr(), h.data_ptr(),
                c.data_ptr(), None if m_t is None else out.data_ptr(), params,
                stream)
        _count("lstm_cell", f64)
        return h, c, out
    b, n = h_prev.shape
    ws = torch.empty(b, 4 * n, device=h_prev.device,
                     dtype=torch.float64 if f64 else torch.float32)
    with _build.on_device(idx):
        _build.launch("dl4j_lstm_cell", xw_t.data_ptr(), h_prev.data_ptr(),
                      c_prev.data_ptr(), RW.data_ptr(), pw_ptr, None, None,
                      None, ws.data_ptr(), params, stream)
    _count("lstm_cell", f64)
    kernels.variant_launches["lstm_cell"]["zout"].add()
    if route == "callable":
        kernels.variant_launches["lstm_cell"]["callable"].add()
        acc = ws.dtype
        h, c, out = _cell_tail(
            *torch.split(ws, n, dim=-1), h_prev.to(acc), c_prev.to(acc),
            None if pW is None else pW.to(acc),
            None if m_t is None else m_t.to(acc), gate_activation,
            activation)
        dt = h_prev.dtype
        h, c = h.to(dt), c.to(dt)
        return h, c, (h if m_t is None else out.to(dt))
    h, c = torch.empty_like(h_prev), torch.empty_like(h_prev)
    out = h if m_t is None else torch.empty_like(h_prev)
    with _build.on_device(idx):
        _build.launch("dl4j_lstm_cell_rows", ws.data_ptr(), h_prev.data_ptr(),
                      c_prev.data_ptr(), pw_ptr,
                      None if m_t is None else m_t.data_ptr(), h.data_ptr(),
                      c.data_ptr(), None if m_t is None else out.data_ptr(),
                      rows_params, stream)
    _count("lstm_cell_rows", f64)
    return h, c, out


def _count(name, f64) -> None:
    kernels.launches[name].add()
    if f64:
        kernels.variant_launches[name]["f64"].add()


def _setup(xw_t, h_prev, c_prev, RW, pW, m_t, gate_activation, activation):
    """The checks that depend on shapes, dtypes and activations alone
    (raising as the kernel cannot take them), then the route ("cell": one
    launch; "rows": the "z out" launch and the row kernel; "callable": the
    "z out" launch and the user's function) and the launches' scalars:
    `(route, params, address, row params, address)`."""
    gate = _act_code(gate_activation)
    act = _act_code(activation)
    dt = xw_t.dtype
    code = DTYPE_CODES.get(dt)
    if code is None:
        raise TypeError(f"lstm_cell takes float32, bfloat16, float16 or "
                        f"float64 on the card, not {dt}")
    b, n = h_prev.shape
    _refuse(xw_t, h_prev, c_prev, RW, pW, m_t, layout=False)
    if gate is None or act is None:
        route = "callable"
    elif SOFTMAX_CODE in (gate, act):
        route = "rows"
    else:
        route = "cell"
    zout = route != "cell"
    params = _CellParams(xw_t.stride(0), b, n, 0 if zout else act,
                         0 if zout else gate, code, int(zout))
    rows = _CellParams(0, b, n, act or 0, gate or 0, code, 0)
    return (route, params, ctypes.addressof(params), rows,
            ctypes.addressof(rows))


def _act_code(activation):
    """The kernels' code for a gate or cell activation (None = identity):
    a built-in elementwise one's (`ACT_CODES`), softmax's
    (`SOFTMAX_CODE`), or None for the user's function (a callable, a
    registered name); an unknown name raises ValueError."""
    activations.resolve(activation)  # an unknown name raises ValueError
    name = activations.builtin(activation)
    if name == "softmax":
        return SOFTMAX_CODE
    return None if name is None else ACT_CODES[name]


def _refuse(xw_t, h_prev, c_prev, RW, pW, m_t, layout=True):
    """Raise for the first operand the kernel cannot take: its shape and
    dtype, then (with `layout`) its layout."""
    dt = xw_t.dtype
    b, n = h_prev.shape
    want = [("h_prev", h_prev, (b, n)), ("xw_t", xw_t, (b, 4 * n)),
            ("c_prev", c_prev, (b, n)), ("RW", RW, (n, 4 * n))]
    if pW is not None:
        want.append(("pW", pW, (3 * n,)))
    if m_t is not None:
        want.append(("m_t", m_t, (b,)))
    for name, t, shape in want:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"lstm_cell: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, want {shape} {dt}")
        if layout and name != "xw_t" and not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} must be contiguous")
    if layout:
        raise ValueError("lstm_cell: xw_t's rows must be contiguous")
