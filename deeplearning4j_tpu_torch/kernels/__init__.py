"""The port's hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper, the kernel's plain PyTorch version and
a launch count. The wrapper picks by where its tensors lie, and by nothing
else: a CPU tensor goes to the plain version (the CPU tests' path); a CUDA
tensor launches the kernel, or the wrapper raises. No fallback, no switch.

- `norm_act.layernorm_norm_act`             (csrc/norm_act.cu)
- `norm_act.batchnorm_norm_act`             (csrc/norm_act.cu)
- `flash_attention.flash_attention`         (csrc/flash_attention.cu)
- `flash_attention.paged_decode_attention`  (csrc/paged_attention.cu)
- `flash_attention.flash_attention_fwd_lse` (csrc/flash_attention.cu)
- `flash_attention.flash_attention_bwd`     (csrc/flash_attention_bwd.cu:
  two kernels, `flash_attention_bwd_dq` and `flash_attention_bwd_dkv`)
  These four run bf16 at D = 64 or 128 on the tensor cores (the tile
  kernels of csrc/flash_attention_stream.cu over one block per whole row
  of tiles), all else on the CUDA cores, by `flash_variant`, each form
  counted in `variant_launches`.
- `fused_update.apply_step`                 (csrc/fused_update.cu: the
  training step's update, params and state in place, one launch per step;
  `fused_update.dispatch`, the per-layer seam that returns deltas, is the
  same kernel in its deltas mode)
- `bottleneck_block.bottleneck_forward`     (csrc/bottleneck_block.cu:
  `bottleneck_train`, batch statistics, and `bottleneck_infer`, running
  statistics; each counts one per wrapper call, of several CUDA launches;
  bf16 at widths that are multiples of 64 on the tensor cores, all else on
  the CUDA cores, by `bottleneck_variant`, each form counted in
  `variant_launches`)
- `lstm_cell.lstm_cell`                     (csrc/lstm_cell.cu: one LSTM
  time step of one layer)
- `flash_attention.flash_attention_stream`  (csrc/flash_attention_stream.cu:
  the streamed forward past the resident K/V limit, with or without lse;
  bf16 at D = 64 or 128 on the tensor cores, else on the CUDA cores, by
  `flash_variant`, each form counted in `variant_launches`)
- `flash_attention.flash_attention_bwd_stream` (csrc/flash_attention_stream.cu:
  two kernels, `flash_attention_bwd_dq_stream` and
  `flash_attention_bwd_dkv_stream`, each on the tensor cores or the CUDA
  cores by `flash_variant`; the streamed wrappers each count one
  per call, of a unit kernel and a merge or sum kernel)

Training reaches the kernels through `torch.autograd.Function`s
(`flash_attention.FlashAttentionFn`, `norm_act.LayerNormFn`,
`norm_act.BatchNormFn`, `bottleneck_block.BottleneckFn`,
`lstm_cell.LSTMCellFn`, see `_diff.py`);
a kernel wrapper asked for a gradient outside them raises.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict

KERNELS = ("layernorm_norm_act", "flash_attention", "paged_decode_attention",
           "flash_attention_fwd_lse", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "fused_update", "batchnorm_norm_act",
           "bottleneck_train", "bottleneck_infer", "lstm_cell",
           "flash_attention_stream", "flash_attention_bwd_dq_stream",
           "flash_attention_bwd_dkv_stream")


class Count:
    """An integer count that threads may add to (the decode loop launches
    from its own thread while callers read). `add` is one `next()` on an
    `itertools.count`, which the interpreter runs as one step, so adds from
    several threads are never lost and take no lock. An `itertools.count`
    has no read that leaves it as it is, so `value` takes one `next()` too
    and subtracts the reads made before it; readers alone take the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def add(self) -> None:
        next(self._c)

    @property
    def value(self) -> int:
        with self._lock:
            n = next(self._c) - self._reads
            self._reads += 1
            return n

    def reset(self) -> None:
        with self._lock:
            self._c, self._reads = itertools.count(), 0


# Kernel launches, counted where each wrapper launches its kernel and
# nowhere else; plain-version calls, counted in the plain versions.
launches: Dict[str, Count] = {name: Count() for name in KERNELS}
plain_calls: Dict[str, Count] = {name: Count() for name in KERNELS}
# Launches of a kernel that has more than one form on the card, by form
# (`flash_attention.flash_variant`, `bottleneck_block.bottleneck_variant`):
# the flash rows 3-7 and the bottleneck rows 11-12. Each also counts once
# in `launches`.
variant_launches: Dict[str, Dict[str, Count]] = {
    name: {"wgmma": Count(), "cuda_cores": Count()}
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_stream", "flash_attention_bwd_dq_stream",
                 "flash_attention_bwd_dkv_stream", "bottleneck_train",
                 "bottleneck_infer")}


def reset_counts() -> None:
    for c in (*launches.values(), *plain_calls.values(),
              *(c for v in variant_launches.values() for c in v.values())):
        c.reset()


def counts() -> Dict[str, Dict[str, int]]:
    return {"launches": {n: c.value for n, c in launches.items()},
            "plain_calls": {n: c.value for n, c in plain_calls.items()},
            "variants": {n: {k: c.value for k, c in v.items()}
                         for n, v in variant_launches.items()}}


def placement(*tensors) -> str:
    """'cpu' or 'cuda' for tensors that all lie on one device; raises for
    mixed devices and for any other device type."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(
                f"tensors on different devices: {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(
            f"tensors on {dev}: the port runs its kernels on 'cuda' and "
            "their plain versions on 'cpu'")
    return dev.type
