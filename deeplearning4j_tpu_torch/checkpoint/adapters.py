"""Adapter checkpoints: LoRA deltas saved as small committed snapshots
(counterpart of `deeplearning4j_tpu/checkpoint/adapters.py`).

A fine-tuned tenant is a rank-r delta over a shared base (`nn/lora.py`).
This module saves exactly that delta, the `__lora_*` leaves, through the
sharded store's commit protocol (`store.write_snapshot`: a tmp dir,
fsync, COMMIT, rename), in the reference's layout, so an adapter that
either package saves loads in the other.

Every save is pinned to `base_fingerprint(net)`, a hash of the base's
(non-LoRA) leaves: their key paths, shapes, dtype names and raw bytes, the
same 32 hex digits as the reference gives for the same base.
`load_adapter` refuses a base whose fingerprint differs: merged onto other
weights, a delta gives a plausible wrong model rather than an error.
`serving/host.py` keeps many adapters beside one resident base and merges
per request (`lora.merge_adapter`).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.checkpoint import store
from deeplearning4j_tpu_torch.checkpoint.array_store import (
    CheckpointError,
    dtype_name,
    host_copies,
    leaf_chunks,
    read_full,
    to_tensor,
)
from deeplearning4j_tpu_torch.nn import lora as lora_mod

ADAPTER_FORMAT = "deeplearning4j_tpu/lora-adapter"
ADAPTER_VERSION = 1

_PREFIX = "adapter"


def _params_of(net_or_tree):
    tree = getattr(net_or_tree, "params_tree", net_or_tree)
    if tree is None:
        raise CheckpointError("net is not initialized (params_tree is None)")
    return tree


def base_fingerprint(net_or_tree) -> str:
    """Content hash of the base param leaves (LoRA leaves left out, so a
    net with adapters fingerprints as its bare base): each leaf's key,
    `str(shape)`, dtype name and raw bytes, in key order."""
    base = lora_mod.strip_adapter(_params_of(net_or_tree))
    items = sorted(store._flat_items(base, store._PARAMS),
                   key=lambda kv: kv[0])
    h = hashlib.sha256()
    for (key, leaf), arr in zip(items, host_copies([t for _, t in items])):
        h.update(key.encode())
        h.update(str(tuple(leaf.shape)).encode())
        h.update(dtype_name(leaf.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


def _conf_layers(net):
    conf = getattr(net, "conf", None)
    if conf is None:
        return []
    if hasattr(conf, "vertices"):
        return [v.layer for v in conf.vertices.values()
                if getattr(v, "layer", None) is not None]
    return list(getattr(conf, "layers", []) or [])


def save_adapter(net, path: str, *, name: Optional[str] = None) -> str:
    """Write `net`'s LoRA leaves as a committed adapter checkpoint at
    `path`; the meta records the adapter's name, rank and alpha and the
    fingerprint of the base it was trained over."""
    adapter = lora_mod.extract_adapter(_params_of(net))
    if not adapter:
        raise CheckpointError(
            "net has no LoRA adapter leaves to save (use "
            "TransferLearning(...).add_lora(...) first)")
    items = store._flat_items(adapter, _PREFIX)
    leaves = [{"key": key, "shape": tuple(t.shape),
               "dtype": dtype_name(t.dtype), "chunks": list(leaf_chunks(h))}
              for (key, t), h in zip(items,
                                     host_copies([t for _, t in items]))]
    alphas = {float(getattr(layer, "lora_alpha", None) or 0.0)
              for layer in _conf_layers(net)
              if getattr(layer, "lora_rank", None)} - {0.0}
    meta = {
        "format": ADAPTER_FORMAT,
        "version": ADAPTER_VERSION,
        "name": name or os.path.basename(os.path.normpath(path)),
        "rank": lora_mod.adapter_rank(adapter),
        "alpha": max(alphas) if alphas else None,
        "base_fingerprint": base_fingerprint(net),
        "engine": type(net).__name__,
    }
    return store.write_snapshot({"leaves": leaves, "meta": meta}, str(path))


def is_adapter_checkpoint(path) -> bool:
    """True for a committed adapter checkpoint directory (reads the meta
    only once the COMMIT manifest exists)."""
    if not store.is_sharded_checkpoint(path):
        return False
    try:
        return store.read_meta(str(path)).get("format") == ADAPTER_FORMAT
    except (OSError, ValueError):
        return False


def adapter_meta(path: str) -> dict:
    """The checked meta of an adapter checkpoint (the commit manifest and
    the format tag; no array data read)."""
    path = str(path)
    store.verify_checkpoint(path)
    meta = store.read_meta(path)
    if meta.get("format") != ADAPTER_FORMAT:
        raise CheckpointError(
            f"{path} is a {meta.get('format')!r} checkpoint, not a LoRA "
            f"adapter ({ADAPTER_FORMAT!r})")
    return meta


def load_adapter(path: str, base_net=None,
                 device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """An adapter checkpoint as a delta-only tree (`{layer: {W__lora_*:
    tensor}}`, ready for `lora.merge_adapter`), on `device` (default: the
    base net's, else the CPU). With `base_net`, a base whose fingerprint
    is not the one stored is refused."""
    path = str(path)
    meta = adapter_meta(path)
    if base_net is not None:
        fp = base_fingerprint(base_net)
        want = meta.get("base_fingerprint")
        if fp != want:
            raise CheckpointError(
                f"adapter {meta.get('name')!r} at {path} was trained "
                f"against base {want}, but the resident base fingerprints "
                f"as {fp}: refusing to merge a delta onto different "
                "weights")
    if device is None:
        device = getattr(base_net, "device", None) or "cpu"
    index = store.read_index(path)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, entry in index["leaves"].items():
        parts = key.split("/")
        if parts[0] != _PREFIX or len(parts) != 3:
            raise CheckpointError(f"{path}: unexpected adapter leaf {key!r}")
        _, lk, leaf_name = parts
        out.setdefault(lk, {})[leaf_name] = to_tensor(
            read_full(path, entry), str(entry["dtype"])).to(device)
    return out
