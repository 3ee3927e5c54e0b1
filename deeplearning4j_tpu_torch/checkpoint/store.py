"""Net-level sharded checkpoint (counterpart of
`deeplearning4j_tpu/checkpoint/store.py`): snapshot, atomic directory
commit, restore. The layout on disk is the reference's, so either package
restores what the other saved:

    step_00000042/
      COMMIT        <- format, version, step and {file: size}; written
                       last, after every other file is fsynced
      meta.json     <- engine, the conf's JSON, iteration, epoch, the
                       train-RNG continuation (and a non-default dtype
                       policy)
      index.json    <- per leaf: global shape, dtype, chunks
      chunks/*.bin  <- raw little-endian chunk files (array_store.py)

Leaf keys are `"params/<vertex>/<name>"`, `"updater/<vertex>/<field>/
<name>"` and `"state/<vertex>/<name>"`, every level in sorted order (the
reference's tree-flatten order, which also numbers the chunk files).

Atomic commit: everything goes into `step_N.tmp/` and is fsynced, then the
COMMIT manifest, then one `os.rename` publishes the step. A crash leaves a
committed step or a `.tmp` that readers ignore; a file truncated after the
commit fails the manifest's size check before any data is read.

`snapshot_net` runs on the training thread and makes owned host copies
(`array_store.host_copies`: on the card, every copy started into pinned
memory before one wait); `write_snapshot` touches only numpy and the
disk, so any thread can run it.

`restore_checkpoint` with a `net` writes the saved values into its
existing tensors (`copy_`): autograd leaves, the fused update's packed
tables and every outside reference stay valid. With `net=None` it builds
the engine from the checkpoint's own conf on `device`, its params from
the checkpoint. A mesh or a `ParallelContext` (ROADMAP A.13) is refused.

Precision policies: the updater tree carries the f32 masters
(`updater/_master/<vertex>/<name>`) and the loss-scale pair
(`updater/_ls/0`, `updater/_ls/1`) as the reference's tree-flatten names
them, so they save and restore like any leaf. A leaf's dtype must be the
target's (`_check_leaf_dtype`, the reference's contract: f32 <-> f64 only
converts). A post-training-quantized checkpoint (`checkpoint/
quantize.py`, `meta["quantization"]`) has int8 leaves with `__scale`
companions that no conf's params declare: its params tree is assembled
from the index with the stored dtypes (`_assemble_params_from_index`),
its BatchNorm state restored, and it has no updater state.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.checkpoint.array_store import (
    CHUNK_DIR,
    CheckpointCorruptError,
    CheckpointError,
    _fsync_write,
    dtype_name,
    host_copies,
    leaf_chunks,
    read_full,
    to_tensor,
    write_leaf,
)
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import (
    DtypePolicy,
    conf_policy,
)
from deeplearning4j_tpu_torch.nn.lora import LORA_SCALE

COMMIT = "COMMIT"
META = "meta.json"
INDEX = "index.json"
FORMAT = "deeplearning4j_tpu/sharded-checkpoint"
VERSION = 1

# The trees a checkpoint holds, by key prefix.
_PARAMS, _UPDATER, _STATE = "params", "updater", "state"


def _flat_items(tree, prefix: str) -> List[Tuple[str, torch.Tensor]]:
    """`(key, tensor)` for every leaf of a nested dict (or tuple) tree,
    dict keys sorted at every level."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        elif node is not None:
            out.append(("/".join([prefix] + path), node))

    walk(tree, [])
    return out


# ------------------------------------------------------------------- save


def snapshot_net(net) -> Dict[str, Any]:
    """Host snapshot of the full training state, on the caller's thread:
    params, updater state, layer state, counters and the RNG
    continuation. The result is host data only (see the module
    docstring)."""
    trees = [(_PARAMS, net.params_tree), (_UPDATER, net.opt_state),
             (_STATE, net.state or None)]
    items = [kv for prefix, tree in trees for kv in _flat_items(tree, prefix)]
    hosts = host_copies([t for _, t in items])
    leaves = [{"key": key, "shape": tuple(t.shape),
               "dtype": dtype_name(t.dtype),
               "chunks": list(leaf_chunks(h))}
              for (key, t), h in zip(items, hosts)]
    meta = {
        "format": FORMAT,
        "version": VERSION,
        "engine": type(net).__name__,
        "conf_json": net.conf.to_json(),
        "iteration": int(net.iteration),
        "epoch": int(net.epoch),
        "rng": np.asarray(net._train_rng).tolist(),
    }
    pol = conf_policy(net.conf.global_conf)
    if not pol.is_default:
        meta["dtype_policy"] = pol.to_dict()
    return {"leaves": leaves, "meta": meta}


def snapshot_nbytes(snap) -> int:
    """Array bytes a snapshot holds."""
    return sum(chunk[1].nbytes for leaf in snap["leaves"]
               for chunk in leaf["chunks"])


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_snapshot(snap: Dict[str, Any], final_dir: str) -> str:
    """Write a snapshot as a committed checkpoint directory (the protocol
    in the module docstring). Returns `final_dir`."""
    tmp = final_dir + ".tmp"
    if os.path.isdir(tmp):  # stale half-write from a crashed save
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, CHUNK_DIR))
    files: Dict[str, int] = {}
    index = {"format": FORMAT, "version": VERSION, "leaves": {}}
    for leaf_id, leaf in enumerate(snap["leaves"]):
        index["leaves"][leaf["key"]] = write_leaf(
            tmp, leaf_id, leaf["key"], leaf["chunks"], leaf["shape"],
            leaf["dtype"], files)
    meta = dict(snap["meta"])
    meta["step"] = _step_of(final_dir)
    files[META] = _fsync_write(os.path.join(tmp, META),
                               json.dumps(meta).encode())
    files[INDEX] = _fsync_write(os.path.join(tmp, INDEX),
                                json.dumps(index).encode())
    _fsync_write(os.path.join(tmp, COMMIT), json.dumps({
        "format": FORMAT, "version": VERSION, "step": meta["step"],
        "files": files,
    }).encode())
    _fsync_dir(os.path.join(tmp, CHUNK_DIR))
    _fsync_dir(tmp)
    if os.path.isdir(final_dir):
        # Re-saving a step (a replay after a rollback): the old committed
        # directory goes first; the committed tmp survives a crash here.
        shutil.rmtree(final_dir)
    os.rename(tmp, final_dir)
    _fsync_dir(os.path.dirname(final_dir) or ".")
    return final_dir


def _step_of(path: str) -> Optional[int]:
    m = re.match(r"^step_(\d+)$", os.path.basename(path))
    return int(m.group(1)) if m else None


def save_checkpoint(net, path: str) -> str:
    """Synchronous save of `net` as a committed checkpoint at `path`."""
    return write_snapshot(snapshot_net(net), str(path))


# ---------------------------------------------------------------- restore


def is_sharded_checkpoint(path) -> bool:
    """True if `path` is a committed checkpoint directory."""
    return os.path.isdir(str(path)) and os.path.isfile(
        os.path.join(str(path), COMMIT))


def verify_checkpoint(path: str) -> dict:
    """Check the commit and every file's size (no array data is read);
    returns the COMMIT manifest. `CheckpointCorruptError` for a missing
    COMMIT or a missing or truncated file."""
    path = str(path)
    if not os.path.isdir(path):
        raise CheckpointError(f"no checkpoint directory at {path}")
    commit_path = os.path.join(path, COMMIT)
    if not os.path.isfile(commit_path):
        raise CheckpointCorruptError(
            f"{path} has no COMMIT manifest: the save never committed "
            "(crash mid-write?); use an earlier committed step")
    try:
        with open(commit_path) as f:
            commit = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable COMMIT in {path}: {e}") from e
    for rel, size in commit.get("files", {}).items():
        full = os.path.join(path, rel)
        try:
            actual = os.path.getsize(full)
        except OSError:
            raise CheckpointCorruptError(f"{path}: missing file {rel}")
        if actual != size:
            raise CheckpointCorruptError(
                f"{path}: {rel} is {actual} bytes, manifest says {size} "
                "(truncated or corrupt)")
    return commit


def read_meta(path: str) -> dict:
    with open(os.path.join(str(path), META)) as f:
        return json.load(f)


def read_index(path: str) -> dict:
    with open(os.path.join(str(path), INDEX)) as f:
        return json.load(f)


def _check_leaf_dtype(key: str, entry: dict, target: str) -> None:
    """f32 <-> f64 converts silently (the reference's rule); any other
    mismatch, a bf16/f16 or an integer leaf among them, raises: a
    low-precision checkpoint onto a full-precision net must be an explicit
    decision, never a silent cast."""
    saved = str(entry["dtype"])
    if saved != target and not ({saved, target} <= {"float32", "float64"}):
        raise CheckpointError(
            f"leaf {key!r} dtype mismatch: checkpoint stores {saved}, "
            f"target net expects {target}: the checkpoint was saved under "
            "a different dtype policy (or post-training-quantized); build "
            "the target net with a matching .dtype_policy(...) (or restore "
            "with net=None to rebuild from the checkpoint's own config) "
            "instead of relying on a silent cast")


def _read_leaf(base: str, index: dict, key: str, shape, target: str
               ) -> torch.Tensor:
    """One leaf as a CPU tensor, its shape and dtype checked against the
    target's."""
    entry = index["leaves"].get(key)
    if entry is None:
        raise CheckpointError(
            f"checkpoint at {base} has no leaf {key!r}: was it saved from a "
            "different model config?")
    if tuple(entry["shape"]) != tuple(shape):
        raise CheckpointError(
            f"leaf shape mismatch: checkpoint has {tuple(entry['shape'])}, "
            f"target net has {tuple(shape)}: config/topology differs")
    _check_leaf_dtype(key, entry, target)
    return to_tensor(read_full(base, entry), str(entry["dtype"]))


def _restore_tree(tree, prefix: str, index: dict, base: str) -> None:
    """Write the checkpoint's leaves into `tree`'s tensors, by key, in
    place."""
    with torch.no_grad():
        for key, t in _flat_items(tree, prefix):
            t.copy_(_read_leaf(base, index, key, t.shape,
                               dtype_name(t.dtype)))


def _build_net(meta: dict, index: dict, base: str, device):
    """A fresh engine from the checkpoint's conf on `device`, its params
    read from the checkpoint (mirrors `model_serializer.load_model`), a
    LoRA layer's adapter leaves among them (`__lora_scale` at f32)."""
    from deeplearning4j_tpu_torch.util.model_serializer import engine_classes

    engines = engine_classes()
    if meta.get("engine") not in engines:
        raise CheckpointError(f"unknown engine {meta.get('engine')!r} in "
                              f"{base}/{META}")
    conf_cls, net_cls = engines[meta["engine"]]
    net = net_cls(conf_cls.from_json(meta["conf_json"]), device=device)
    target = dtype_name(net.dtype_policy.param_dtype)
    params = {name: {k: _read_leaf(base, index, f"{_PARAMS}/{name}/{k}",
                                   shape, "float32" if k.endswith(
                                       LORA_SCALE) else target)
                     for k, shape in params_mod.layer_param_shapes(
                         layer).items()}
              for name, layer in net._layer_confs.items()}
    return net.init(params=params)


def _check_policy_match(meta: dict, net, path: str) -> None:
    """Before any chunk is read: a checkpoint saved under a policy whose
    params have another dtype than the target net's is refused, naming the
    policies."""
    saved = meta.get("dtype_policy")
    if saved is None:
        return
    saved_pol = DtypePolicy.of(saved)
    target = conf_policy(net.conf.global_conf)
    if saved_pol.resolved()[0] != target.resolved()[0]:
        raise CheckpointError(
            f"{path} was saved under dtype policy "
            f"{saved_pol.name!r} (params stored as "
            f"{saved_pol.resolved()[0]}), but the target net's "
            f"policy {target.name!r} expects "
            f"{target.resolved()[0]} params: refusing to silently "
            f"cast. Build the target with .dtype_policy({saved_pol.name!r})"
            " or restore with net=None to rebuild from the checkpoint's own "
            "config.")


def _assemble_params_from_index(index: dict, base: str, device):
    """The params tree taken from the index (reference
    `_assemble_params_from_index`, store.py:343), each leaf at its stored
    dtype on `device`: int8 weights stay int8 (that is the serving
    saving), and the forward dequantizes them at use."""
    params: Dict[str, Any] = {}
    for key, entry in index["leaves"].items():
        if not key.startswith(_PARAMS + "/"):
            continue
        node = params
        parts = key.split("/")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = to_tensor(read_full(base, entry),
                                    str(entry["dtype"])).to(device)
    return params


def _restore_quantized(meta, index, path, net, device):
    """A quantized checkpoint into `net` (or a net built from its conf):
    params from the index, BatchNorm state, counters."""
    if net is None:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            engine_classes,
        )

        engines = engine_classes()
        if meta.get("engine") not in engines:
            raise CheckpointError(f"unknown engine {meta.get('engine')!r} "
                                  f"in {path}/{META}")
        conf_cls, net_cls = engines[meta["engine"]]
        net = net_cls(conf_cls.from_json(meta["conf_json"]), device=device)
    if net.params_tree is None:
        net.init()
    net.params_tree = _assemble_params_from_index(index, path, net.device)
    net._update_tables.clear()
    net._compute_params = None
    if net.state:
        _restore_tree(net.state, _STATE, index, path)
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    return net


def restore_checkpoint(path: str, net=None, mesh=None, context=None,
                       load_updater: bool = True, device="cuda"):
    """Restore a committed checkpoint: params, updater state (unless
    `load_updater` is False or the checkpoint has none), layer state,
    iteration, epoch and the RNG continuation.

    `net=None` builds the engine from the checkpoint's conf on `device`;
    a given net is written in place (see the module docstring). A
    checkpoint saved from a mesh restores whole onto the one device.
    """
    if mesh is not None or context is not None:
        raise NotImplementedError(
            "restore_checkpoint onto a mesh or a ParallelContext is not in "
            "the port yet (ROADMAP A.13); the port restores onto one device")
    path = str(path)
    verify_checkpoint(path)
    meta = read_meta(path)
    index = read_index(path)
    if net is not None:
        _check_policy_match(meta, net, path)
    if meta.get("quantization"):
        return _restore_quantized(meta, index, path, net, device)
    if net is not None:
        if net.params_tree is None:
            net.init()
        _restore_tree(net.params_tree, _PARAMS, index, path)
    else:
        net = _build_net(meta, index, path, device)
    has_updater = any(k.startswith(_UPDATER + "/") for k in index["leaves"])
    if load_updater and net.opt_state is not None and has_updater:
        _restore_tree(net.opt_state, _UPDATER, index, path)
    if net.state:
        _restore_tree(net.state, _STATE, index, path)
    net._compute_params = None  # the inference copy is stale now
    net.iteration = int(meta.get("iteration", 0))
    net.epoch = int(meta.get("epoch", 0))
    if meta.get("rng") is not None:
        net._train_rng = np.asarray(meta["rng"], np.uint32)
    return net
