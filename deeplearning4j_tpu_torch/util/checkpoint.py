"""Periodic checkpoints written off the training thread, and exact resume
(counterpart of `deeplearning4j_tpu/util/checkpoint.py`).

A checkpoint is the full training state: params, updater state, declared
layer state, iteration and epoch, and the train-RNG continuation. A net
loaded from one and trained on gives the uninterrupted run's params bit
for bit.

Two formats, as in the reference:

- `"zip"`: the model zip (`util/model_serializer.py`, so `load_model`
  opens it too) plus a `training/rng.npy` entry holding the RNG key;
- `"sharded"`: a committed step directory of `checkpoint/store.py`.

`load_checkpoint` opens both: a directory is sharded (a step, or a
manager root whose newest committed step wins), a file a zip.

`CheckpointListener` takes the snapshot at the iteration's end, on the
training thread (owned host copies: the step updates params and state in
place), and encodes and writes it on one background thread, one write in
flight at most (`checkpoint/manager.py`'s `BackgroundWrite`; a sharded
listener saves through a `CheckpointManager`). Its zips are
`save_model`'s (`model_serializer.host_snapshot` and `write_zip`),
deflated at zlib level 1 (the reference's listener uses the default 6;
the entries are the same bytes).
"""

from __future__ import annotations

import io
import os
import shutil
import time
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.checkpoint import store as sharded_store
from deeplearning4j_tpu_torch.checkpoint.manager import (
    BackgroundWrite,
    CheckpointManager,
)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.util import model_serializer

RNG_ENTRY = "training/rng.npy"


def _rng_bytes(key) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.asarray(key, np.uint32))
    return buf.getvalue()


def _zip_snapshot(net) -> Dict[str, Any]:
    """`write_zip`'s arguments for a checkpoint: the model zip's owned host
    copies plus the RNG entry."""
    snap = model_serializer.host_snapshot(net)
    snap["extra"] = {RNG_ENTRY: _rng_bytes(net._train_rng)}
    return snap


def _write_zip(snap: Dict[str, Any], path: str) -> None:
    tmp = path + ".tmp"
    model_serializer.write_zip(tmp, **snap)
    os.replace(tmp, path)  # atomic: a crash never leaves a torn file


def save_checkpoint(net, path, format: str = "zip") -> str:
    """Synchronous full-state checkpoint: `"zip"`, the model zip plus the
    RNG entry; `"sharded"`, a committed checkpoint directory at `path`."""
    if format == "sharded":
        return sharded_store.save_checkpoint(net, path)
    if format != "zip":
        raise ValueError(f"format must be 'zip' or 'sharded', got {format!r}")
    _write_zip(_zip_snapshot(net), str(path))
    return str(path)


def _read_rng(path):
    with zipfile.ZipFile(path) as z:
        if RNG_ENTRY in z.namelist():
            return np.load(io.BytesIO(z.read(RNG_ENTRY))).astype(np.uint32)
    return None


def load_checkpoint(path, mesh=None, context=None, device="cuda"):
    """A net on `device` with the checkpoint's full training state, whose
    next `fit` step is the one the checkpointed run would have taken. A
    directory is a sharded checkpoint, a file a zip. A mesh or a context
    is refused (ROADMAP A.13)."""
    if os.path.isdir(str(path)):
        from deeplearning4j_tpu_torch.checkpoint import legacy

        return legacy.load_any(path, device=device, mesh=mesh,
                               context=context)
    if mesh is not None or context is not None:
        raise NotImplementedError(
            "load_checkpoint onto a mesh or a ParallelContext is not in the "
            "port yet (ROADMAP A.13)")
    net = model_serializer.load_model(path, load_updater=True, device=device)
    key = _read_rng(path)
    if key is not None:
        net._train_rng = key
    return net


def load_into(net, path) -> None:
    """Write the checkpoint at `path` (either format, of `net`'s conf) into
    `net` in place: its tensors stay the same objects."""
    if os.path.isdir(str(path)):
        from deeplearning4j_tpu_torch.checkpoint import legacy

        legacy.load_any(path, net=net)
        return
    model_serializer.load_into(net, path, load_updater=True)
    net._compute_params = None
    key = _read_rng(path)
    if key is not None:
        net._train_rng = key


class CheckpointListener(IterationListener):
    """Checkpoint every `frequency` iterations, keep the newest
    `keep_last`, write off the training thread (module docstring).

    `format="zip"` writes `filename_pattern` files; `format="sharded"`
    writes committed `step_{iteration:08d}/` directories through a
    `CheckpointManager`. `saved_paths` lists the committed checkpoints
    oldest first; `load_checkpoint` opens any of them. `flush` (also
    called by `on_epoch_end`, `last_checkpoint` and the next save) waits
    for the write in flight and raises its error, if it had one; only
    then does a write join `saved_paths`. `timings` holds the seconds of
    the last `checkpoint.snapshot` (training thread) and
    `checkpoint.write` (background thread).
    """

    def __init__(self, directory: str, frequency: int = 100,
                 keep_last: int = 3,
                 filename_pattern: str = "checkpoint_iter{iteration}.zip",
                 format: str = "zip"):
        if format not in ("zip", "sharded"):
            raise ValueError(
                f"format must be 'zip' or 'sharded', got {format!r}")
        self.directory = directory
        self.frequency = max(1, int(frequency))
        self.keep_last = int(keep_last)
        self.filename_pattern = filename_pattern
        self.format = format
        os.makedirs(directory, exist_ok=True)
        if format == "sharded":
            # Retention is the listener's, over `saved_paths` (which the
            # watchdog edits): the manager keeps every step.
            self._writes = CheckpointManager(directory, keep_last=0)
            self.timings: Dict[str, float] = self._writes.timings
        else:
            self._writes = BackgroundWrite()
            self.timings = {}
        self._pending: Optional[str] = None
        self.saved_paths: List[str] = []

    def _prune(self) -> None:
        while self.keep_last > 0 and len(self.saved_paths) > self.keep_last:
            old = self.saved_paths.pop(0)
            try:
                if os.path.isdir(old):
                    shutil.rmtree(old)
                else:
                    os.remove(old)
            except OSError:
                pass

    # ---------------------------------------------------------------- hook

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency != 0:
            return
        self.flush()  # one write in flight at most
        if self.format == "sharded":
            self._pending = self._writes.save(model, iteration)
            return
        t0 = time.perf_counter()
        snap = _zip_snapshot(model)
        self.timings["checkpoint.snapshot"] = time.perf_counter() - t0
        path = os.path.join(self.directory,
                            self.filename_pattern.format(iteration=iteration))

        def write():
            t0 = time.perf_counter()
            _write_zip(snap, path)
            self.timings["checkpoint.write"] = time.perf_counter() - t0

        self._writes.start(snap, write)
        self._pending = path

    def on_epoch_end(self, model) -> None:
        self.flush()

    def flush(self) -> None:
        path, self._pending = self._pending, None
        self._writes.flush()  # raises the write's error: `path` not kept
        if path is None:
            return
        # Record and prune only after the new checkpoint is in place: a
        # crash mid-write must not have deleted the last good one. A
        # re-saved iteration (a replay after a rollback) moves its entry
        # instead of adding a second one, which `_prune` would later
        # delete from under the first.
        if path in self.saved_paths:
            self.saved_paths.remove(path)
        self.saved_paths.append(path)
        self._prune()

    def last_checkpoint(self) -> Optional[str]:
        self.flush()
        return self.saved_paths[-1] if self.saved_paths else None
