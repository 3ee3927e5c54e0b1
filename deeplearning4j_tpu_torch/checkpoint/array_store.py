"""Chunked on-disk array store (counterpart of
`deeplearning4j_tpu/checkpoint/array_store.py`): the leaf layer of the
sharded checkpoint format, byte for byte the reference's layout.

Every leaf is stored as one or more raw little-endian chunk files, plus an
entry in `index.json`: the global shape, the dtype's name, and each chunk's
`[start, stop)` interval per dimension.

- The port, on one card, writes one chunk per leaf covering all of it. A
  checkpoint the reference saved from a mesh holds one chunk per distinct
  shard region; `read_region` and `read_full` assemble any region from the
  chunks that overlap it.
- numpy has no bfloat16 (the reference reads it through `ml_dtypes`). Here
  a bf16 chunk is read as raw `<u2` and viewed as `torch.bfloat16`
  (`to_tensor`), and a bf16 tensor is written as the same two bytes per
  element.
- `host_copies` makes the owned host copies a snapshot needs: the training
  step writes params and updater state in place, so a view of them would
  change under a background writer at the next step.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

CHUNK_DIR = "chunks"

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


class CheckpointError(RuntimeError):
    """Base error for the sharded checkpoint store."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint that looked present failed validation (truncated chunk,
    missing file, uncovered region, no COMMIT manifest)."""


def dtype_name(dtype: torch.dtype) -> str:
    """The index's name of a torch dtype (numpy's spelling)."""
    try:
        return _TORCH_NAMES[dtype]
    except KeyError:
        raise CheckpointError(f"no checkpoint dtype for {dtype}") from None


def resolve_dtype(s: str) -> np.dtype:
    """The numpy dtype a chunk of dtype name `s` is read as: bfloat16 as
    its raw `<u2` bits (see the module docstring), the rest as numpy names
    them."""
    if s == "bfloat16":
        return np.dtype("<u2")
    try:
        return np.dtype(s)
    except TypeError:
        raise CheckpointError(
            f"checkpoint dtype {s!r} is not one the port reads") from None


def to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of the chunk data `arr` read for dtype name `dtype`."""
    arr = np.ascontiguousarray(arr)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("<u2")
    return t.numpy()


def host_copies(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Owned host copies of `tensors`, as numpy. A CPU tensor is cloned. A
    card tensor is copied into pinned memory without blocking, every copy
    started before one wait on each card's current stream. The arrays keep
    their pinned buffers alive: drop them on a thread that may make CUDA
    calls (freeing pinned memory can)."""
    out: List[torch.Tensor] = []
    streams = {}
    with torch.no_grad():
        for t in tensors:
            t = t.detach()
            if t.device.type == "cpu":
                out.append(t.clone(memory_format=torch.contiguous_format))
                continue
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            streams.setdefault(t.device,
                               torch.cuda.current_stream(t.device))
            out.append(buf)
    for stream in streams.values():
        stream.synchronize()
    return [_as_numpy(t) for t in out]


def leaf_chunks(arr: np.ndarray
                ) -> Iterator[Tuple[Tuple[Tuple[int, int], ...], np.ndarray]]:
    """`(index, data)` for the one chunk of a leaf held whole on the host:
    `index` is `((0, dim), ...)`."""
    yield tuple((0, int(s)) for s in np.shape(arr)), arr


def _fsync_write(path: str, data: bytes) -> int:
    """Durable file write: every chunk must be on disk before the COMMIT
    manifest is."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return len(data)


def write_leaf(dirpath: str, leaf_id: int, key: str,
               chunks: List[Tuple[Tuple[Tuple[int, int], ...], np.ndarray]],
               shape: Tuple[int, ...], dtype: str,
               files: Dict[str, int]) -> dict:
    """Write one leaf's chunk files under `dirpath/chunks/`; returns its
    index entry and records each file's size in `files` (the COMMIT
    manifest's validation data)."""
    entry = {"shape": [int(s) for s in shape], "dtype": str(dtype),
             "chunks": []}
    for i, (idx, data) in enumerate(chunks):
        rel = f"{CHUNK_DIR}/l{leaf_id:05d}.c{i:03d}.bin"
        files[rel] = _fsync_write(os.path.join(dirpath, rel),
                                  np.ascontiguousarray(data).tobytes())
        entry["chunks"].append({"file": rel,
                                "index": [[int(a), int(b)] for a, b in idx]})
    return entry


def _open_chunk(dirpath: str, chunk: dict, dtype: np.dtype) -> np.ndarray:
    """Memory-map one chunk (pages are read as a region needs them)."""
    shape = tuple(b - a for a, b in chunk["index"])
    path = os.path.join(dirpath, chunk["file"])
    try:
        if not shape:  # 0-d leaf: memmap requires shape=(1,)
            return np.fromfile(path, dtype=dtype, count=1).reshape(())
        return np.memmap(path, dtype=dtype, mode="r", shape=shape)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"chunk {chunk['file']} unreadable or truncated "
            f"(expected shape {shape}, dtype {dtype}): {e}") from e


def read_region(dirpath: str, entry: dict, region) -> np.ndarray:
    """Assemble `entry[region]` (a tuple of slices in global coordinates)
    from whatever chunks overlap it. Raises `CheckpointCorruptError` if the
    chunks do not cover the region."""
    shape = tuple(entry["shape"])
    dtype = resolve_dtype(entry["dtype"])
    if not shape:
        return _open_chunk(dirpath, entry["chunks"][0], dtype).copy()
    region = tuple(sl.indices(dim) for sl, dim in zip(region, shape))
    region = tuple(slice(a, b) for a, b, _ in region)
    out_shape = tuple(sl.stop - sl.start for sl in region)
    out = np.empty(out_shape, dtype)
    covered = np.zeros(out_shape, bool)
    for chunk in entry["chunks"]:
        cidx = [(int(a), int(b)) for a, b in chunk["index"]]
        inter = []
        for (a, b), sl in zip(cidx, region):
            lo, hi = max(a, sl.start), min(b, sl.stop)
            if lo >= hi:
                inter = None
                break
            inter.append((lo, hi))
        if inter is None:
            continue
        mm = _open_chunk(dirpath, chunk, dtype)
        src = tuple(slice(lo - a, hi - a)
                    for (a, _), (lo, hi) in zip(cidx, inter))
        dst = tuple(slice(lo - sl.start, hi - sl.start)
                    for sl, (lo, hi) in zip(region, inter))
        out[dst] = mm[src]
        covered[dst] = True
    if not covered.all():
        raise CheckpointCorruptError(
            f"chunks cover only {int(covered.sum())}/{covered.size} elements "
            f"of requested region {region} (global shape {shape})")
    return out


def read_full(dirpath: str, entry: dict) -> np.ndarray:
    """The whole leaf (as `resolve_dtype` reads it)."""
    shape = tuple(entry["shape"])
    return read_region(dirpath, entry, tuple(slice(0, s) for s in shape))
