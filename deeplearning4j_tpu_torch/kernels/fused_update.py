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

For the precision policies `apply_step` takes two more things:
- `skip`, a device int32 scalar (nonzero: the step's loss-scaled gradients
  were not all finite). On the card the launch reads it and writes
  nothing; on the CPU the plain version computes the step and selects the
  old values back (`torch.where`), as the reference's `jnp.where(finite,
  new, old)` does. The host never reads it.
- `UpdateItem.lowp`, the stored bf16 or f16 params of an item whose
  `params` are their f32 masters: the kernel writes the master and its
  round-to-nearest-even cast in the same launch, the plain version copies
  the updated master into them.

For a captured CUDA graph (`nn/superstep.py`) the launch has a third
form, the device-scalar form: the 8 shared floats and the per-tensor lrs,
baked into a launch's parameters otherwise, are read from a device buffer
that the host refills before each replay. An `apply_step` given a
`ScalarSlots` (`slots=`) takes a slot of it for each launch and records
what fills it: the kind, hyperparameters, step and
each tensor's schedule (`UpdateItem.lr_of`); `ScalarSlots.fill(shift)`
computes, for the step `shift` iterations later, the values the host form
computes (the same f32 arithmetic, rounded once), and moves them all with
one copy. Those launches count in `kernels.variant_launches
["fused_update"]["device_scalars"]` too.

float64 (a float64 policy's step, and its gradient checks): params, state
and grads of one dtype, f32 or f64, per (kind, hyper) group. An f64 group
launches the kernel's float64 form (the same entry at dtype code 4, the
kernel over doubles; counted also in
`kernels.variant_launches["fused_update"]["f64"]`), whose scalars go
over as doubles in both the host and the device-scalar form: each tensor's
lr and bc1, bc2 as the f32 values `scalars` computes (what the plain
version multiplies by, widened exactly), the kind's constants (1 - beta1,
...) and the factors in double, as the plain version's Python floats are.
It has no low-precision copies (a float64 policy stores f64 params).

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
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import kernels
from deeplearning4j_tpu_torch.kernels import _build

KINDS = ("adam", "nesterovs", "rmsprop")
FIELDS = {"adam": ("m", "v"), "nesterovs": ("v",), "rmsprop": ("g2",)}
_KIND_CODES = {"adam": 0, "nesterovs": 1, "rmsprop": 2}
_DELTAS, _SUB, _ADD = 0, 1, 2  # csrc/fused_update.cu modes
_MAX_TENSORS = 256  # csrc/fused_update.cu kMaxTensors
# The stored copies' dtype codes (csrc/common.cuh).
_LP_CODES = {torch.bfloat16: 1, torch.float16: 3}


class UpdateItem(NamedTuple):
    """One layer vertex's share of `apply_step`: `params`, `grads` and each
    state field's tensors by param name (the grads' names are updated);
    its scheduled `lr`; `factors`, the bias-rate factor of each param name
    that has one (absent: 1); `lowp`, the stored bf16 or f16 params when
    `params` are their f32 masters (None otherwise)."""
    params: Dict[str, torch.Tensor]
    state: Dict[str, Dict[str, torch.Tensor]]
    grads: Dict[str, torch.Tensor]
    lr: float
    factors: Optional[Dict[str, float]] = None
    lowp: Optional[Dict[str, torch.Tensor]] = None
    lr_of: Optional[Callable[[int], float]] = None


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


def _kernel_scalars(kind, step, hyper, wide: bool = False):
    """The kernel's 8 shared scalars: bc1, bc2, then the kind's constants
    with each (1 - x) computed in double and rounded once to f32, as the
    reference's Python-float constants are; with `wide`, the float64
    form's 8 doubles, the constants unrounded."""
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
    return array.array("d" if wide else "f", vals + [0.0] * (8 - len(vals)))


# The group dtypes the kernel takes, and their codes (csrc/common.cuh).
_DTYPE_CODES = {torch.float32: 0, torch.float64: 4}
_DTYPES = tuple(_DTYPE_CODES)


def _refuse(mode, k, tensors, n, idx, dtype=torch.float32):
    """Raise for the first of an entry's tensors the kernel cannot take;
    `dtype` is the group's (its first grad's), f32 or f64."""
    for what, t in zip(("param" if mode else "delta", "grad", "state",
                        "state", "stored param"), tensors):
        if t is None:
            continue
        if what == "stored param":
            if t.dtype not in _LP_CODES or dtype != torch.float32:
                raise TypeError(f"fused_update writes bfloat16 or float16 "
                                f"stored params beside float32 masters; "
                                f"{k!r} has {t.dtype}")
        elif t.dtype not in _DTYPES:
            raise TypeError(f"fused_update takes float32 or float64 params, "
                            f"state and grads; {what} of {k!r} has "
                            f"{t.dtype}")
        elif t.dtype != dtype:
            raise TypeError(f"fused_update takes one dtype per group: "
                            f"{what} of {k!r} has {t.dtype}, the group "
                            f"{dtype}")
        if t.get_device() != idx:
            raise ValueError(f"fused_update: {what} of {k!r} lies on "
                             f"{t.device}, not on cuda:{idx}")
        if not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"fused_update: {what} of {k!r} must be "
                             f"contiguous and hold its grad's {n} elements")


_ptr, _numel = torch.Tensor.data_ptr, torch.Tensor.numel
_device, _contiguous = torch.Tensor.get_device, torch.Tensor.is_contiguous


def _grads_ok(grads, sizes, idx, dtype) -> bool:
    """Whether every grad is of `dtype` on card `idx`, contiguous, of its
    size."""
    return (list(map(_numel, grads)) == sizes
            and {g.dtype for g in grads} == {dtype}
            and set(map(_device, grads)) == {idx}
            and all(map(_contiguous, grads)))


class _Table:
    """The kernel's arguments over one list of tensors, checked and packed
    by `_pack`: `kept`, the tensors the kernel writes (every out, then
    every s0, then every s1, then every stored low-precision param), and
    their addresses; the element count per entry; then, over the entries
    with elements (`live`: their indices, None when that is all), the
    addresses of out, s0, s1, lp (0 for none) and grad, the size, lr and
    factor; `lp_code`, the stored params' dtype code (0: none); `dtype`,
    the group's, f32 or f64 (`wide`: the float64 form).
    `apply_step` reuses a group's table from step to step while its params
    and state are the kept tensors at the kept addresses, and renews only
    the grads, lrs and factors (`_regrad`)."""

    __slots__ = ("idx", "kept", "addrs", "numels", "live", "outs", "s0s",
                 "s1s", "lps", "lp_code", "sizes", "gs", "lrs", "facs",
                 "lr_ofs", "dtype", "wide")

    def _select(self, per_entry):
        live = self.live
        return per_entry if live is None else [per_entry[i] for i in live]


def _pack(mode, entries) -> _Table:
    """Check every entry, `(out, grad, s0, s1 or None, lr, factor, name,
    the stored low-precision param or None)`, and pack it into a `_Table`
    (on the grads' card)."""
    t = _Table()
    t.idx = idx = entries[0][1].get_device()
    f32 = t.dtype = entries[0][1].dtype  # the group's dtype
    t.wide = f32 == torch.float64
    if f32 not in _DTYPES:
        _refuse(mode, entries[0][6], (None, entries[0][1]), 0, idx)
    lp0 = entries[0][7]
    for out, g, s0, s1, lr, factor, k, lp, *_ in entries:
        if (lp is None) != (lp0 is None) or (lp is not None and (
                lp.dtype != lp0.dtype or lp.dtype not in _LP_CODES
                or lp.get_device() != idx
                or not lp.is_contiguous() or lp.numel() != g.numel())):
            if lp is not None:
                _refuse(mode, k, (None, None, None, None, lp), g.numel(),
                        idx, f32)
            raise ValueError(f"fused_update: the stored params of {k!r} "
                             "must match the group's (one dtype, on the "
                             "grads' card, contiguous, the grad's size)")
        # What the kernel's pointers need, in one condition (the cheap
        # path; `_refuse` names the tensor at fault): the group's dtype on
        # the grads' card, contiguous, the grad's element count.
        n = g.numel()
        if not ((s1 is None or (s1.dtype is f32 and s1.get_device() == idx
                                and s1.is_contiguous() and s1.numel() == n))
                and out.dtype is f32 and g.dtype is f32 and s0.dtype is f32
                and out.get_device() == idx and g.get_device() == idx
                and s0.get_device() == idx and out.is_contiguous()
                and g.is_contiguous() and s0.is_contiguous()
                and out.numel() == n and s0.numel() == n):
            _refuse(mode, k, (out, g, s0, s1), n, idx, f32)
    if lp0 is not None and t.wide:
        _refuse(mode, entries[0][6], (None, None, None, None, lp0), 0, idx,
                f32)
    t.lp_code = 0 if lp0 is None else _LP_CODES[lp0.dtype]
    t.numels = [e[1].numel() for e in entries]
    t.live = (None if all(t.numels) else
              [i for i, n in enumerate(t.numels) if n])
    t.kept = [e[0] for e in entries] + [e[2] for e in entries]
    if entries[0][3] is not None:
        t.kept += [e[3] for e in entries]
    if lp0 is not None:
        t.kept += [e[7] for e in entries]
    t.addrs = list(map(_ptr, t.kept))
    n = len(entries)
    t.outs, t.s0s = t._select(t.addrs[:n]), t._select(t.addrs[n:2 * n])
    s1_at = 2 * n if entries[0][3] is not None else None
    t.s1s = t._select(t.addrs[s1_at:s1_at + n] if s1_at else [0] * n)
    t.lps = t._select([_ptr(e[7]) for e in entries] if lp0 is not None
                      else [0] * n)
    t.sizes = t._select(t.numels)
    t.gs = t._select([_ptr(e[1]) for e in entries])
    t.lrs = t._select([e[4] for e in entries])
    t.facs = t._select([e[5] for e in entries])
    t.lr_ofs = t._select([e[8] if len(e) > 8 else None for e in entries])
    return t


def _regrad(t, kind, items) -> bool:
    """Renew table `t`'s grads, lrs and factors from `items` if their
    params and state are its kept tensors, in its order and at its
    addresses, and say whether they were; a grad the kernel cannot take
    raises as in `_pack`."""
    now = [it.params[k] for it in items for k in it.grads]
    for f in FIELDS[kind]:
        now += [it.state[f][k] for it in items for k in it.grads]
    if items[0].lowp is not None:
        now += [it.lowp[k] for it in items for k in it.grads]
    if (len(now) != len(t.kept) or not all(map(operator.is_, now, t.kept))
            or list(map(_ptr, now)) != t.addrs):
        return False
    grads = [g for it in items for g in it.grads.values()]
    if not _grads_ok(grads, t.numels, t.idx, t.dtype):
        names = [k for it in items for k in it.grads]
        for g, n, k in zip(grads, t.numels, names):
            _refuse(_SUB, k, (None, g), n, t.idx, t.dtype)
    t.gs = t._select(list(map(_ptr, grads)))
    t.lrs = t._select([it.lr for it in items for _ in it.grads])
    t.lr_ofs = t._select([it.lr_of for it in items for _ in it.grads])
    t.facs = t._select([it.factors.get(k, 1.0) if it.factors else 1.0
                        for it in items for k in it.grads])
    return True


class ScalarSlots:
    """A device buffer of launch scalars for the device-scalar form (see
    the module docstring): each launch given it takes the next slot, 8
    shared scalars then one lr per tensor, and the slot remembers how to
    compute them for any step. A float64 launch's slot holds doubles, two
    floats each, from an even offset. `capacity` floats (4-byte units), on
    card `device`."""

    def __init__(self, capacity: int, device):
        self.device = torch.device(device)
        self.buf = torch.zeros(capacity, dtype=torch.float32,
                               device=self.device)
        self.host = torch.zeros(capacity, dtype=torch.float32,
                                pin_memory=True)
        self.used = 0
        self.slots = []  # (offset, kind, hyper, step, lr_ofs)
        self._copied = None  # the event after the last copy from `host`

    def take(self, kind, hyper, step, lrs, lr_ofs, wide=False) -> int:
        """A slot for one launch of `len(lrs)` tensors at `step`, filled
        with the values of that step (doubles with `wide`); returns its
        device address."""
        if wide:
            self.used += self.used % 2  # 8-byte aligned
        n = (8 + len(lrs)) * (2 if wide else 1)
        if self.used + n > self.buf.numel():
            raise RuntimeError("fused_update: the scalar slots are full")
        if any(f is None for f in lr_ofs):
            raise ValueError("fused_update: a device-scalar launch needs "
                             "every tensor's schedule (UpdateItem.lr_of)")
        off = self.used
        self.used += n
        self.slots.append((off, kind, hyper, step, list(lr_ofs), wide))
        self._write(off, kind, hyper, step, lrs, wide)
        if not torch.cuda.is_current_stream_capturing():
            # An eager launch reads the slot now; under capture `fill`
            # writes it before each replay.
            self.buf[off:off + n].copy_(self.host[off:off + n],
                                        non_blocking=True)
        return self.buf.data_ptr() + 4 * off

    def _write(self, off, kind, hyper, step, lrs, wide=False):
        vals = _kernel_scalars(kind, step, hyper, wide)
        if wide:  # the lrs as the f32 values the plain version uses
            vals.extend(float(np.float32(lr)) for lr in lrs)
        else:
            vals.extend(array.array("f", lrs))
        raw = torch.frombuffer(vals, dtype=torch.uint8).view(torch.float32)
        self.host[off:off + raw.numel()] = raw

    def fill(self, shift: int = 0) -> None:
        """Every slot's values for its step + `shift`, in one copy to the
        device on the current stream (which the next replay reads)."""
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has read `host`
        for off, kind, hyper, step, lr_ofs, wide in self.slots:
            s = step + shift
            self._write(off, kind, hyper, s, [f(s) for f in lr_ofs], wide)
        self.buf[:self.used].copy_(self.host[:self.used], non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()



def _run(kind, hyper, step, mode, table, skip=None, slots=None) -> None:
    """Launch the kernel over `table`'s entries in slices of
    `_MAX_TENSORS` and bump the version counter of every tensor it wrote.
    The lrs and factors are rounded to f32 by the arrays, as `np.float32`
    rounds them; a float64 table's go over as doubles (the lrs as their
    f32 values, widened), to the kernel's float64 form. `skip`: the device
    int32 flag, or None. `slots`: a `ScalarSlots` each launch takes its
    scalars from (the device-scalar form), or None."""
    t = table
    if t.sizes:
        wide = t.wide
        sc = _kernel_scalars(kind, step, hyper, wide)
        code = _KIND_CODES[kind]
        stream = _build.current_stream(t.idx)
        with _build.on_device(t.idx):
            for i in range(0, len(t.sizes), _MAX_TENSORS):
                j = i + _MAX_TENSORS
                ptrs = array.array("Q", t.outs[i:j] + t.gs[i:j] + t.s0s[i:j]
                                   + t.s1s[i:j] + t.lps[i:j])
                size = array.array("q", t.sizes[i:j])
                lr = (array.array("d", (float(np.float32(x))
                                        for x in t.lrs[i:j])) if wide
                      else array.array("f", t.lrs[i:j]))
                fac = array.array("d" if wide else "f", t.facs[i:j])
                dev = (None if slots is None else
                       slots.take(kind, hyper, step, t.lrs[i:j],
                                  t.lr_ofs[i:j], wide))
                _build.launch("dl4j_fused_update", code, mode, len(size),
                              ptrs.buffer_info()[0], size.buffer_info()[0],
                              lr.buffer_info()[0], fac.buffer_info()[0],
                              sc.buffer_info()[0], _DTYPE_CODES[t.dtype],
                              t.lp_code,
                              None if skip is None else skip.data_ptr(),
                              dev, stream)
                if wide:
                    kernels.variant_launches["fused_update"]["f64"].add()
                kernels.launches["fused_update"].add()
                if dev is not None:
                    kernels.variant_launches["fused_update"][
                        "device_scalars"].add()
    torch.autograd.graph.increment_version(t.kept)


def launch_scalars_floats(table) -> int:
    """Floats (4-byte units) a `ScalarSlots` holds for one `_run` over
    `table`: a float64 table's doubles take two each, and one more a
    launch for the alignment."""
    n = len(table.sizes)
    launches = -(-n // _MAX_TENSORS)
    if table.wide:
        return 2 * (n + 8 * launches) + launches
    return n + 8 * launches


def _item_tensors(kind, it):
    """An item's grads and the params, state and stored params of their
    names."""
    fields = [it.state[f] for f in FIELDS[kind]]
    for k, g in it.grads.items():
        yield g
        yield it.params[k]
        for s in fields:
            yield s[k]
        if it.lowp is not None:
            yield it.lowp[k]


def _check_skip(skip, idx) -> None:
    if skip is not None and (skip.dtype != torch.int32 or skip.numel() != 1
                             or skip.get_device() != idx):
        raise ValueError("fused_update: the skip flag must be one int32 on "
                         f"the grads' card (cuda:{idx})")


def apply_step(kind, hyper, items: List[UpdateItem], step, sign,
               tables: Optional[dict] = None, skip=None,
               slots: Optional[ScalarSlots] = None) -> list:
    """Update state and params of every item in place (see the module
    docstring); `hyper` is the kind's positional hyperparameter tuple,
    `step` the host iteration count, `sign` +1 to minimize, -1 to
    maximize. `tables`, a dict the caller keeps from step to step (the
    engine keeps one per network), holds the packed kernel arguments of
    each (kind, hyper) group between steps (`_Table`): a step whose params
    and state are the packed tensors then checks and packs only its grads.
    `slots`, a `ScalarSlots`, gives the card's launches the device-scalar
    form (the plain versions compute with host values either way).
    Returns each item's new state: on the card the same tensors, on the
    CPU the plain versions' new ones (the old ones, selected back, where
    `skip` is set). Tensors on more than one device raise, whichever item
    comes first."""
    if kind not in KINDS:
        raise ValueError(f"fused_update has no {kind!r} body; it has {KINDS}")
    first = next((g for it in items for g in it.grads.values()), None)
    if first is None:
        return [it.state for it in items]
    if kernels.placement(first) == "cpu":
        kernels.placement(*(t for it in items for t in _item_tensors(kind,
                                                                     it)),
                          *([] if skip is None else [skip]))
        keep = None if skip is None else skip == 0
        out = []
        for it in items:
            kernels.plain_calls["fused_update"].add()
            st, deltas = _PLAIN[kind](it.state, it.grads, it.lr, step, *hyper)
            old = None if keep is None else {k: it.params[k].clone()
                                             for k in deltas}
            apply_deltas(it.params, deltas, it.factors, sign)
            if keep is not None:
                for k in deltas:
                    it.params[k].copy_(torch.where(keep, it.params[k], old[k]))
                st = {f: {k: torch.where(keep, v, it.state[f][k])
                          for k, v in fs.items()} for f, fs in st.items()}
            if it.lowp is not None:
                for k in deltas:
                    it.lowp[k].copy_(it.params[k])
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
                                factors.get(k, 1.0), k,
                                None if it.lowp is None else it.lowp[k],
                                it.lr_of))
        table = _pack(mode, entries)
        if tables is not None:
            tables[key] = table
    _check_skip(skip, table.idx)
    _run(kind, hyper, step, mode, table, skip, slots)
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
         k, None) for k, g in grads.items()]))
    return state, deltas
