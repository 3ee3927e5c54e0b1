"""Post-training int8 quantization of committed checkpoints, for serving
(counterpart of `deeplearning4j_tpu/checkpoint/quantize.py`, numpy only and
copied: its output equals the reference's bit for bit).

`quantize_checkpoint(src, dst)` reads a committed sharded checkpoint and
writes a new committed one whose eligible weight leaves are int8 with a
per-channel f32 scale:

    W  (float [in, out])  ->  W        (int8 [in, out])
                              W__scale (float32 [out])

Per-channel symmetric over the last axis (the output channel of Dense
[in, out] and HWIO conv kernels): `scale = max|W| / 127` per channel
(1.0 for an all-zero one), `q = clip(rint(W / scale), -127, 127)`.
Eligible leaves are floating params of two or more dims; biases, gains and
BatchNorm statistics stay (as f32). A bfloat16 leaf is neither, as numpy
sees it in the reference (an `ml_dtypes` type is no `np.floating`): it
passes through as it is. The result is a serving artifact: the
updater state is dropped, `meta["quantization"]` marks it (so
`store.restore_checkpoint` assembles the params tree from the index and
serving reports "int8"), and the saved dtype policy is removed (the
weights are int8 now). At inference the int8 tensors stay int8 on the
device; `nn/params.prep_layer_params` dequantizes `q * scale` at the
compute dtype, and a `BottleneckBlock` hands them to row 12's kernel as
they are.

CLI: python -m deeplearning4j_tpu_torch.checkpoint.quantize <src> <dst>
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.checkpoint import store as store_mod
from deeplearning4j_tpu_torch.checkpoint.array_store import (
    CheckpointError,
    leaf_chunks,
    read_full,
)

INT8_SCHEME = "int8_per_channel_symmetric"
SCALE_SUFFIX = "__scale"


def quantize_array(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric int8 over the last axis: (q, scale), `scale`
    shaped (w.shape[-1],); an all-zero channel gets scale 1.0."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(range(w.ndim - 1))
    amax = np.max(np.abs(w), axis=reduce_axes) if reduce_axes else np.abs(w)
    scale = np.where(amax > 0.0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale


def _eligible(arr: np.ndarray) -> bool:
    return arr.ndim >= 2 and np.issubdtype(arr.dtype, np.floating)


def quantize_tree(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize a `{layer: {name: array or tensor}}` params tree in memory:
    eligible leaves become int8 with a `<name>__scale` sibling, other
    floating leaves f32, the rest pass through (numpy arrays; a bf16
    tensor stays a bf16 tensor)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = quantize_tree(v)
            continue
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            out[k] = v.detach().cpu().clone()
            continue
        a = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        if _eligible(a):
            q, scale = quantize_array(a)
            out[k] = q
            out[k + SCALE_SUFFIX] = scale
        elif np.issubdtype(a.dtype, np.floating):
            out[k] = a.astype(np.float32)
        else:
            out[k] = a
    return out


def quantize_net(net):
    """Quantize a live net's params in place, on its device, for serving
    (training it afterwards is refused)."""
    q = quantize_tree(net.params_tree)
    net.params_tree = {lk: {pn: torch.as_tensor(a).to(net.device)
                            for pn, a in lp.items()}
                       for lk, lp in q.items()}
    net._compute_params = None
    net._update_tables.clear()
    return net


def quantize_checkpoint(src: str, dst: str,
                        meta_extra: Optional[dict] = None) -> str:
    """Write the int8 serving checkpoint of the committed checkpoint at
    `src` to `dst` (the same atomic commit). Returns `dst`."""
    src, dst = str(src), str(dst)
    store_mod.verify_checkpoint(src)
    meta = store_mod.read_meta(src)
    index = store_mod.read_index(src)
    if meta.get("quantization"):
        raise CheckpointError(f"{src} is already quantized")
    leaves = []
    n_quant = 0

    def add(key: str, arr: np.ndarray, dtype=None) -> None:
        leaves.append({"key": key, "shape": tuple(arr.shape),
                       "dtype": dtype or str(arr.dtype),
                       "chunks": list(leaf_chunks(arr))})

    for key, entry in index["leaves"].items():
        if key.startswith(store_mod._UPDATER + "/"):
            continue  # a serving artifact: the updater state is dropped
        arr = np.asarray(read_full(src, entry))
        if str(entry["dtype"]) == "bfloat16":  # raw bits: kept as they are
            add(key, arr, "bfloat16")
            continue
        if key.startswith(store_mod._PARAMS + "/") and _eligible(arr):
            q, scale = quantize_array(arr)
            add(key, q)
            add(key + SCALE_SUFFIX, scale)
            n_quant += 1
        else:
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)
            add(key, arr)
    meta = dict(meta)
    meta["quantization"] = {"scheme": INT8_SCHEME, "axis": "last",
                            "quantized_leaves": n_quant}
    meta.pop("dtype_policy", None)  # the weights are int8 now
    if meta_extra:
        meta.update(meta_extra)
    return store_mod.write_snapshot({"leaves": leaves, "meta": meta}, dst)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.checkpoint.quantize",
        description="Post-training int8 quantization of a committed "
                    "checkpoint (per-channel symmetric, serving only).")
    ap.add_argument("src", help="committed checkpoint step directory")
    ap.add_argument("dst", help="output directory for the int8 checkpoint")
    args = ap.parse_args(argv)
    print(quantize_checkpoint(args.src, args.dst))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
