"""Fused optimizer update (counterpart of
`deeplearning4j_tpu/kernels/fused_update.py`).

Two entries over one kernel, `csrc/fused_update.cu` (replacing
`_adam_kernel`, `_nesterovs_kernel`, `_rmsprop_kernel`,
fused_update.py:109,121,129), for `adam`, `nesterovs` and `rmsprop`:

- `apply_step(kind, hyper, items, step, sign, tables)`, the training
  step's entry (`nn/engine.py`): every layer vertex of one updater kind and
  hyperparameter tuple (`UpdateItem`s: params, state, grads, the layer's
  scheduled lr, per-tensor bias-rate factors). Per element d = body(...),
  d * factor where a factor is given, then p - d (sign > 0) or p + d,
  state and params IN PLACE. CUDA tensors: one kernel launch over all the
  items' tensors, and one more per `_MAX_TENSORS` past the first (the
  kernel's table capacity); no delta tensor exists. The packed pointer
  table can be kept from step to step by the caller (`tables`), and is
  then checked and packed anew only where a param or state tensor
  changed; each step checks its grads. CPU tensors: per item,
  the plain version, the factor, then `sub_`/`add_`, one plain call each,
  as the engine did per layer before the step had one entry.
- `dispatch(kind, state, grads, lr, step, hyper)`, `ops/updaters.py`'s
  per-layer seam with the JAX contract: `state` is the kind's fields
  (`{"m": {name: t}, "v": {...}}`, `{"v": ...}`, `{"g2": ...}`) over one
  layer's params, `grads` is `{name: t}`, and it returns
  `(new_state, deltas)`, the caller subtracting the deltas. CUDA tensors:
  the same kernel in its deltas mode, one launch, state IN PLACE. CPU
  tensors: the plain versions `adam_xla`, `nesterovs_xla`, `rmsprop_xla`,
  the JAX package's XLA bodies (fused_update.py:77-103) transcribed op for
  op; they return new tensors.

On the card the apply mode equals the deltas mode followed by `d * factor`
and `p.sub_(d)` bit for bit (the kernel's note says how). Both take lr,
bc1 = 1 - beta1^t and bc2 = 1 - beta2^t as f32 values, computed on the
host in f32 as `_scalars` (fused_update.py:159) does, with t = step + 1
and `step` the iteration before it is counted. The kernel writes through
raw pointers, so each wrapper bumps the autograd version counter of every
tensor it wrote, as `sub_` would.
"""

from __future__ import annotations

import array
import operator
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build

KINDS = ("adam", "nesterovs", "rmsprop")
FIELDS = {"adam": ("m", "v"), "nesterovs": ("v",), "rmsprop": ("g2",)}
_KIND_CODES = {"adam": 0, "nesterovs": 1, "rmsprop": 2}
_DELTAS, _SUB, _ADD = 0, 1, 2  # csrc/fused_update.cu modes
_MAX_TENSORS = 256  # csrc/fused_update.cu kMaxTensors


class UpdateItem(NamedTuple):
    """One layer vertex's share of `apply_step`: `params`, `grads` and each
    state field's tensors by param name (the grads' names are updated);
    its scheduled `lr`; `factors`, the bias-rate factor of each param name
    that has one (absent: 1)."""
    params: Dict[str, torch.Tensor]
    state: Dict[str, Dict[str, torch.Tensor]]
    grads: Dict[str, torch.Tensor]
    lr: float
    factors: Optional[Dict[str, float]] = None


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


def apply_deltas(params, deltas, factors, sign) -> None:
    """params[k] -= deltas[k] (sign > 0) or += (sign < 0), each delta first
    scaled by factors[k] where there is one: the engine's per-layer update,
    the plain version of the kernel's apply mode."""
    for k, p in params.items():
        if k in deltas:
            d = deltas[k]
            if factors and k in factors:
                d = d * factors[k]
            p.sub_(d) if sign > 0 else p.add_(d)


def _kernel_scalars(kind, step, hyper):
    """The kernel's 8 shared floats: bc1, bc2, then the kind's constants
    with each (1 - x) computed in double and rounded once, as the
    reference's Python-float constants are."""
    _, bc1, bc2 = scalars(0.0, step, kind, hyper)
    if kind == "adam":
        b1, b2, eps = hyper
        rest = (b1, 1 - b1, b2, 1 - b2, eps)
    elif kind == "nesterovs":
        (mom,) = hyper
        rest = (mom, 1.0 + mom)
    else:
        decay, eps = hyper
        rest = (decay, 1 - decay, eps)
    vals = [float(bc1), float(bc2), *rest]
    return array.array("f", vals + [0.0] * (8 - len(vals)))


def _refuse(mode, k, tensors, n, idx):
    """Raise for the first of an entry's tensors the kernel cannot take."""
    for what, t in zip(("param" if mode else "delta", "grad", "state",
                        "state"), tensors):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"fused_update takes float32 params, state and "
                            f"grads; {what} of {k!r} has {t.dtype}")
        if t.get_device() != idx:
            raise ValueError(f"fused_update: {what} of {k!r} lies on "
                             f"{t.device}, not on cuda:{idx}")
        if not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"fused_update: {what} of {k!r} must be "
                             f"contiguous and hold its grad's {n} elements")


_ptr, _numel = torch.Tensor.data_ptr, torch.Tensor.numel
_device, _contiguous = torch.Tensor.get_device, torch.Tensor.is_contiguous


def _grads_ok(grads, sizes, idx) -> bool:
    """Whether every grad is f32 on card `idx`, contiguous, of its size."""
    return (list(map(_numel, grads)) == sizes
            and {g.dtype for g in grads} == {torch.float32}
            and set(map(_device, grads)) == {idx}
            and all(map(_contiguous, grads)))


class _Table:
    """The kernel's arguments over one list of tensors, checked and packed
    by `_pack`: `kept`, the tensors the kernel writes (every out, then
    every s0, then every s1), and their addresses; the element count per
    entry; then, over the entries with elements (`live`: their indices,
    None when that is all), the addresses of out, s0, s1 (0 for none) and
    grad, the size, lr and factor. `apply_step` reuses a group's table
    from step to step while its params and state are the kept tensors at
    the kept addresses, and renews only the grads, lrs and factors
    (`_regrad`)."""

    __slots__ = ("idx", "kept", "addrs", "numels", "live", "outs", "s0s",
                 "s1s", "sizes", "gs", "lrs", "facs")

    def _select(self, per_entry):
        live = self.live
        return per_entry if live is None else [per_entry[i] for i in live]


def _pack(mode, entries) -> _Table:
    """Check every entry, `(out, grad, s0, s1 or None, lr, factor, name)`,
    and pack it into a `_Table` (on the grads' card)."""
    f32 = torch.float32
    t = _Table()
    t.idx = idx = entries[0][1].get_device()
    for out, g, s0, s1, lr, factor, k in entries:
        # What the kernel's pointers need, in one condition (the cheap
        # path; `_refuse` names the tensor at fault): f32 on the grads'
        # card, contiguous, the grad's element count.
        n = g.numel()
        if not ((s1 is None or (s1.dtype is f32 and s1.get_device() == idx
                                and s1.is_contiguous() and s1.numel() == n))
                and out.dtype is f32 and g.dtype is f32 and s0.dtype is f32
                and out.get_device() == idx and g.get_device() == idx
                and s0.get_device() == idx and out.is_contiguous()
                and g.is_contiguous() and s0.is_contiguous()
                and out.numel() == n and s0.numel() == n):
            _refuse(mode, k, (out, g, s0, s1), n, idx)
    t.numels = [e[1].numel() for e in entries]
    t.live = (None if all(t.numels) else
              [i for i, n in enumerate(t.numels) if n])
    t.kept = [e[0] for e in entries] + [e[2] for e in entries]
    if entries[0][3] is not None:
        t.kept += [e[3] for e in entries]
    t.addrs = list(map(_ptr, t.kept))
    n = len(entries)
    t.outs, t.s0s = t._select(t.addrs[:n]), t._select(t.addrs[n:2 * n])
    t.s1s = t._select(t.addrs[2 * n:] or [0] * n)
    t.sizes = t._select(t.numels)
    t.gs = t._select([_ptr(e[1]) for e in entries])
    t.lrs = t._select([e[4] for e in entries])
    t.facs = t._select([e[5] for e in entries])
    return t


def _regrad(t, kind, items) -> bool:
    """Renew table `t`'s grads, lrs and factors from `items` if their
    params and state are its kept tensors, in its order and at its
    addresses, and say whether they were; a grad the kernel cannot take
    raises as in `_pack`."""
    now = [it.params[k] for it in items for k in it.grads]
    for f in FIELDS[kind]:
        now += [it.state[f][k] for it in items for k in it.grads]
    if (len(now) != len(t.kept) or not all(map(operator.is_, now, t.kept))
            or list(map(_ptr, now)) != t.addrs):
        return False
    grads = [g for it in items for g in it.grads.values()]
    if not _grads_ok(grads, t.numels, t.idx):
        names = [k for it in items for k in it.grads]
        for g, n, k in zip(grads, t.numels, names):
            _refuse(_SUB, k, (None, g), n, t.idx)
    t.gs = t._select(list(map(_ptr, grads)))
    t.lrs = t._select([it.lr for it in items for _ in it.grads])
    t.facs = t._select([it.factors.get(k, 1.0) if it.factors else 1.0
                        for it in items for k in it.grads])
    return True


def _run(kind, hyper, step, mode, table) -> None:
    """Launch the kernel over `table`'s entries in slices of
    `_MAX_TENSORS` and bump the version counter of every tensor it wrote.
    The lrs and factors are rounded to f32 by the arrays, as `np.float32`
    rounds them."""
    t = table
    if t.sizes:
        sc = _kernel_scalars(kind, step, hyper)
        code = _KIND_CODES[kind]
        stream = _build.current_stream(t.idx)
        with _build.on_device(t.idx):
            for i in range(0, len(t.sizes), _MAX_TENSORS):
                j = i + _MAX_TENSORS
                ptrs = array.array("Q", t.outs[i:j] + t.gs[i:j] + t.s0s[i:j]
                                   + t.s1s[i:j])
                size = array.array("q", t.sizes[i:j])
                lr = array.array("f", t.lrs[i:j])
                fac = array.array("f", t.facs[i:j])
                _build.launch("dl4j_fused_update", code, mode, len(size),
                              ptrs.buffer_info()[0], size.buffer_info()[0],
                              lr.buffer_info()[0], fac.buffer_info()[0],
                              sc.buffer_info()[0], stream)
                kernels.launches["fused_update"].add()
    torch.autograd.graph.increment_version(t.kept)


def _item_tensors(kind, it):
    """An item's grads and the params and state of their names."""
    fields = [it.state[f] for f in FIELDS[kind]]
    for k, g in it.grads.items():
        yield g
        yield it.params[k]
        for s in fields:
            yield s[k]


def apply_step(kind, hyper, items: List[UpdateItem], step, sign,
               tables: Optional[dict] = None) -> list:
    """Update state and params of every item in place (see the module
    docstring); `hyper` is the kind's positional hyperparameter tuple,
    `step` the host iteration count, `sign` +1 to minimize, -1 to
    maximize. `tables`, a dict the caller keeps from step to step (the
    engine keeps one per network), holds the packed kernel arguments of
    each (kind, hyper) group between steps (`_Table`): a step whose params
    and state are the packed tensors then checks and packs only its grads.
    Returns each item's new state: on the card the same tensors, on the
    CPU the plain versions' new ones. Tensors on more than one device
    raise, whichever item comes first."""
    if kind not in KINDS:
        raise ValueError(f"fused_update has no {kind!r} body; it has {KINDS}")
    first = next((g for it in items for g in it.grads.values()), None)
    if first is None:
        return [it.state for it in items]
    if kernels.placement(first) == "cpu":
        kernels.placement(*(t for it in items for t in _item_tensors(kind,
                                                                     it)))
        out = []
        for it in items:
            kernels.plain_calls["fused_update"].add()
            st, deltas = _PLAIN[kind](it.state, it.grads, it.lr, step, *hyper)
            apply_deltas(it.params, deltas, it.factors, sign)
            out.append(st)
        return out
    mode = _SUB if sign > 0 else _ADD
    key = (kind, hyper)
    table = None if tables is None else tables.get(key)
    if table is None or not _regrad(table, kind, items):
        f0 = FIELDS[kind][0]
        entries = []
        for it in items:
            factors = it.factors or {}
            s0, s1 = it.state[f0], it.state["v"] if kind == "adam" else None
            for k, g in it.grads.items():
                entries.append((it.params[k], g, s0[k],
                                None if s1 is None else s1[k], it.lr,
                                factors.get(k, 1.0), k))
        table = _pack(mode, entries)
        if tables is not None:
            tables[key] = table
    _run(kind, hyper, step, mode, table)
    return [it.state for it in items]


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
    f0 = FIELDS[kind][0]
    s1 = state["v"] if kind == "adam" else None
    deltas = {k: torch.empty_like(g) for k, g in grads.items()}
    _run(kind, hyper, step, _DELTAS, _pack(_DELTAS, [
        (deltas[k], g, state[f0][k], None if s1 is None else s1[k], lr, 1.0,
         k) for k, g in grads.items()]))
    return state, deltas
