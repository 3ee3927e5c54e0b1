"""Failure detection and recovery in place (counterpart of
`deeplearning4j_tpu/util/failure.py`).

`FailureDetectionListener` watches the training score; on NaN or inf it
rolls the live net back to the newest healthy checkpoint a
`CheckpointListener` wrote (params, updater state, layer state, counters,
RNG continuation), and training goes on with the same net object.

- A checkpoint is healthy when every param and updater-state value in it
  is finite: with momentum-family updaters the state goes non-finite a
  step before the params do.
- `restore_in_place` writes the checkpoint into the net's existing tensors
  (`util/checkpoint.load_into`): the fused update's packed tables, the
  autograd leaves and every outside reference to the net stay valid, and
  the next step updates the restored params.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.checkpoint import store as sharded_store
from deeplearning4j_tpu_torch.checkpoint.array_store import (
    CheckpointError,
    read_full,
    to_tensor,
)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.util import checkpoint as ckpt_mod
from deeplearning4j_tpu_torch.util import model_serializer


# What an unreadable or damaged checkpoint raises here.
_UNREADABLE = (CheckpointError, OSError, ValueError, KeyError,
               zipfile.BadZipFile)


class TrainingDivergedError(RuntimeError):
    """Raised when divergence persists past `max_recoveries` rollbacks."""


def restore_in_place(net, path: str) -> None:
    """Load the checkpoint at `path` into `net` (same conf): params,
    updater state, layer state, iteration, epoch, RNG continuation. The
    score reads NaN until the next step."""
    ckpt_mod.load_into(net, path)
    net._score = None


def _checkpoint_healthy(path: str) -> bool:
    """True if every param and updater-state value in the checkpoint is
    finite; either format (a sharded one is read leaf by leaf)."""
    if os.path.isdir(path):
        try:
            sharded_store.verify_checkpoint(path)
            index = sharded_store.read_index(path)
            for key, entry in index["leaves"].items():
                if not (key.startswith("params/")
                        or key.startswith("updater/")):
                    continue
                arr = to_tensor(read_full(path, entry), entry["dtype"])
                if not bool(arr.float().isfinite().all()):
                    return False
            return True
        except _UNREADABLE:
            return False
    try:
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            params = np.frombuffer(
                z.read(model_serializer.COEFFICIENTS), np.float64)
            if not np.all(np.isfinite(params)):
                return False
            if model_serializer.UPDATER_STATE in names:
                upd = np.frombuffer(
                    z.read(model_serializer.UPDATER_STATE), np.float64)
                if not np.all(np.isfinite(upd)):
                    return False
        return True
    except _UNREADABLE:
        return False


class FailureDetectionListener(IterationListener):
    """Every `check_frequency` iterations, look at the score; on NaN or
    inf, roll back to the newest healthy checkpoint and keep training.

    The score looked at is the previous check's: by the next check its
    step has long finished, so reading it does not wait on the step being
    watched. Detection lags one interval; the walk over healthy
    checkpoints skips any written inside it.

    `checkpoints` is the CheckpointListener that supplies the rollback
    targets (set it before this listener, so its snapshots come first).
    """

    def __init__(self, checkpoints: ckpt_mod.CheckpointListener, *,
                 check_frequency: int = 10, max_recoveries: int = 3):
        self.checkpoints = checkpoints
        self.check_frequency = max(1, int(check_frequency))
        self.max_recoveries = int(max_recoveries)
        self.recoveries = 0
        self.recovery_log: List[dict] = []
        self._pending = None  # (iteration, device score) from the last check

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.check_frequency:
            return
        previous, self._pending = self._pending, (iteration, model._score)
        if previous is None:
            return
        prev_iter, prev_score = previous
        score = float("nan") if prev_score is None else float(prev_score)
        if np.isfinite(score):
            return
        self._recover(model, prev_iter, score)

    # ------------------------------------------------------------- recovery

    def _recover(self, model, iteration: int, score: float) -> None:
        if self.recoveries >= self.max_recoveries:
            raise TrainingDivergedError(
                f"score {score} at iteration {iteration} after "
                f"{self.recoveries} recoveries: giving up")
        self.checkpoints.flush()  # the write in flight first
        target = self._newest_healthy()
        if target is None:
            raise TrainingDivergedError(
                f"score {score} at iteration {iteration} and no healthy "
                "checkpoint to roll back to")
        restore_in_place(model, target)
        self._pending = None
        # Checkpoints newer than the restore point hold diverged (or soon
        # to diverge) state: drop them, so that a second recovery does not
        # land on one and the replayed iterations save again.
        keep, drop = [], []
        for p in self.checkpoints.saved_paths:
            (keep if p == target or not self._newer_than(p, model.iteration)
             else drop).append(p)
        self.checkpoints.saved_paths[:] = keep
        self.recoveries += 1
        self.recovery_log.append({
            "detected_at_iteration": iteration,
            "restored_from": target,
            "restored_iteration": model.iteration,
            "bad_score": score,
            "dropped_checkpoints": drop,
        })

    @staticmethod
    def _newer_than(path: str, iteration: int) -> bool:
        try:
            if os.path.isdir(path):
                manifest = sharded_store.read_meta(path)
            else:
                with zipfile.ZipFile(path) as z:
                    manifest = json.loads(z.read(model_serializer.MANIFEST))
            return int(manifest.get("iteration", -1)) > iteration
        except _UNREADABLE:
            return True  # unreadable: treat as stale and drop

    def _newest_healthy(self) -> Optional[str]:
        for path in reversed(self.checkpoints.saved_paths):
            if _checkpoint_healthy(path):
                return path
        return None
