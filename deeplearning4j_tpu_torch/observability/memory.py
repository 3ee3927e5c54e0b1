"""Device memory by program and by owner (counterpart of
`deeplearning4j_tpu/observability/memory.py:61-226`, on PyTorch's caching
allocator).

- **By program**: `program_memory(program, net)` wraps a program's first
  dispatch on the card (the engines' `graph.train_step` / `mln.train_step`
  at the first dispatch of a batch signature; the serving warmup's
  `output` and `decode_step`, while the serving loops are quiet) and
  records what the allocator saw: the peak of `max_memory_allocated()`
  above the level before the dispatch, split into the bytes the dispatch
  left allocated (`output`) and the rest (`temp`), beside the net's leaf
  bytes (`argument`). The counterpart of XLA's `memory_analysis()`; it
  feeds `dl4j_program_hbm_bytes{program,kind}`. `max_memory_allocated` is
  process-wide, so a dispatch on another thread meanwhile reads high:
  record on the dispatching thread with nothing else running.
- **By owner**: `live_buffer_report()` attributes the storages of each
  registered net (`register_tree(name, net)`: a weakref, so registration
  never keeps a model alive) to its trees and top-level leaf prefix
  (`params_tree/layer_3`): params, layer state, updater state and the f32
  masters (`opt_state/_master`). Each storage counts once, by its
  `data_ptr`. The rest of `torch.cuda.memory_allocated()` is
  `unattributed_bytes` (the inference copy, KV pages, caches, workspace).

`measured_model_bytes(net)` is what the serving host budgets with: the
net's leaf bytes on the card plus the largest transient (`temp +
output`) recorded for one of its programs; None for a net off the card or
with no recorded program (the caller keeps its estimate). On the CPU only
the leaf part exists.

Nothing here runs in a training step but the first of a signature.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch import observability as _obs

_M_PROGRAM_HBM = _obs.metrics.gauge(
    "dl4j_program_hbm_bytes",
    "Static per-program device memory from XLA's memory_analysis(): "
    "argument/output/temp/generated_code/alias bytes plus their total "
    "(aliased bytes counted once)",
    label_names=("program", "kind"))

_lock = threading.Lock()
_programs: Dict[str, Dict[str, Any]] = {}   # label -> {bytes, net_ref}
_trees: Dict[str, Any] = {}                 # name -> weakref to a net

_TREES = ("params_tree", "state", "opt_state")


def program_label(kind: str, static: Optional[dict] = None) -> str:
    """A stable `program` label: the kind and its static config, e.g.
    `output[model=lm]`."""
    if not static:
        return kind
    inner = ",".join(f"{k}={static[k]}" for k in sorted(static))
    return f"{kind}[{inner}]"


def _storage_key(t) -> tuple:
    st = t.untyped_storage()
    return (t.device.type, t.device.index, st.data_ptr())


def _owned_leaves(net):
    """(tensor, group) pairs of a net's trees, group `attr/prefix` (e.g.
    `params_tree/layer_0`, `opt_state/_master`)."""
    import torch

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                yield from walk(v)
        elif isinstance(tree, torch.Tensor):
            yield tree

    for attr in _TREES:
        tree = getattr(net, attr, None)
        if not isinstance(tree, dict):
            continue
        for prefix, sub in tree.items():
            for t in walk(sub):
                yield t, f"{attr}/{prefix}"


def leaf_bytes(net, device_type: Optional[str] = None) -> int:
    """The bytes of the storages of the net's trees (each once), only
    those on `device_type` if given."""
    seen, total = set(), 0
    for t, _ in _owned_leaves(net):
        if device_type is not None and t.device.type != device_type:
            continue
        key = _storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        total += t.untyped_storage().nbytes()
    return total


def record_program_memory(program: str, before: int, peak: int, after: int,
                          net=None) -> Dict[str, int]:
    """Set `dl4j_program_hbm_bytes{program, kind}` from one dispatch's
    allocator readings (bytes allocated before it, the peak during it, the
    bytes after it) and keep them for `measured_model_bytes`."""
    output = max(0, int(after) - int(before))
    temp = max(0, int(peak) - int(before) - output)
    argument = 0 if net is None else leaf_bytes(net, "cuda")
    stats = {"argument": argument, "output": output, "temp": temp,
             "generated_code": 0, "alias": 0,
             "total": argument + output + temp}
    for kind, v in stats.items():
        _M_PROGRAM_HBM.labels(program=program, kind=kind).set(v)
    with _lock:
        _programs[program] = {
            "bytes": stats,
            "net_ref": None if net is None else weakref.ref(net)}
    return stats


@contextlib.contextmanager
def program_memory(program: str, net=None, device=None):
    """Record the device memory of the dispatch run inside the block as
    `program` (see the module docstring); does nothing off the card. The
    readings are the allocator's counters: no device sync. Resets the
    card's peak-memory counter."""
    import torch

    dev = torch.device(getattr(net, "device", None) or device or "cpu")
    if dev.type != "cuda":
        yield
        return
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ok = False
    try:
        yield
        ok = True
    finally:
        if ok:
            record_program_memory(program, before,
                                  torch.cuda.max_memory_allocated(dev),
                                  torch.cuda.memory_allocated(dev), net=net)


def program_memory_snapshot() -> Dict[str, Dict[str, int]]:
    """{program: {kind: bytes}} of every recorded program."""
    with _lock:
        return {label: dict(rec["bytes"]) for label, rec in _programs.items()}


def largest_transient(net) -> Optional[int]:
    """The largest `temp + output` among the programs recorded for `net`
    (None when none was)."""
    best = None
    with _lock:
        for rec in _programs.values():
            ref = rec.get("net_ref")
            if ref is not None and ref() is net:
                b = rec["bytes"]
                best = max(best or 0, b["temp"] + b["output"])
    return best


# --------------------------------------------------- live-buffer attribution


def register_tree(name: str, net) -> None:
    """Register a model for live-buffer attribution (weakref only)."""
    with _lock:
        _trees[str(name)] = weakref.ref(net)


def unregister_tree(name: str) -> None:
    with _lock:
        _trees.pop(str(name), None)


def live_buffer_report() -> Dict[str, Any]:
    """The storages of each registered net by model and group, and the
    rest of the card's allocated bytes as `unattributed_bytes`."""
    import torch

    with _lock:
        registered = list(_trees.items())
    models: Dict[str, Dict[str, Any]] = {}
    seen = set()
    on_card = 0
    for name, ref in registered:
        net = ref()
        if net is None:
            unregister_tree(name)
            continue
        m = models.setdefault(name, {"bytes": 0, "groups": {}})
        for t, group in _owned_leaves(net):
            key = _storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            nb = t.untyped_storage().nbytes()
            m["bytes"] += nb
            m["groups"][group] = m["groups"].get(group, 0) + nb
            if t.device.type == "cuda":
                on_card += nb
    attributed = sum(m["bytes"] for m in models.values())
    unattributed = 0
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        unattributed = max(0, torch.cuda.memory_allocated() - on_card)
    return {"total_bytes": attributed + unattributed, "models": models,
            "unattributed_bytes": unattributed}


# ------------------------------------------------------- serving integration


def measured_model_bytes(net, transient: Optional[int] = None
                         ) -> Optional[int]:
    """The measured device footprint of a loaded model: the bytes of its
    leaves on the card plus the largest transient recorded for one of its
    programs (or `transient`, one recorded for an earlier load of the
    same model). None when the net is not on the card or has no recorded
    transient: the caller keeps its estimate."""
    if getattr(getattr(net, "device", None), "type", None) != "cuda":
        return None
    if transient is None:
        transient = largest_transient(net)
    if transient is None:
        return None
    return leaf_bytes(net, "cuda") + int(transient)


def report() -> Dict[str, Any]:
    """Per-program accounting and live attribution in one document."""
    return {"programs": program_memory_snapshot(),
            "live": live_buffer_report()}
