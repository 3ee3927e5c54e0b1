"""CheckpointManager (counterpart of
`deeplearning4j_tpu/checkpoint/manager.py`): step-named checkpoints with
retention and saves written off the training thread.

    root/
      step_00000005/      <- committed (has COMMIT)
      step_00000010/
      step_00000015.tmp/  <- half-written save (crash): never listed

- `latest()` and `all_steps()` see only committed steps whose manifest
  validates, so a truncated chunk, a missing COMMIT or a `.tmp` make that
  step absent; `restore()` of a step named explicitly raises
  `CheckpointCorruptError` instead, and `restore()` of the newest walks
  back past every damaged step with a `RuntimeWarning` each.
- Retention keeps the newest `keep_last` steps (all of them when it is
  0) and, with `keep_every=m`, every step divisible by m.
- `save` takes the snapshot on the caller's thread and writes it off it
  through a `BackgroundWrite`: one write in flight at most; `flush` waits
  for it and raises its error, if it had one. `util/checkpoint.py`'s
  listener writes through the same class.
- Observability (reference :45-55, 139, 149, 248): the process-global
  `dl4j_checkpoint_saves_total`, `_restores_total`, `_bytes_written_total`,
  `_bytes_read_total` and `dl4j_checkpoint_queue_depth`, and the
  `checkpoint.snapshot` (caller's thread), `checkpoint.write` (the
  writer's) and `checkpoint.restore` spans. `stats` is a read-only view of
  this manager's share of those counters under their names (and
  `restore_fallback`, the reference's elastic event, as a count);
  `timings` a read-only view of the seconds of this manager's last span
  of each name.
"""

from __future__ import annotations

import contextlib
import os
import re
import shutil
import threading
import time
import warnings
from types import MappingProxyType
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch.checkpoint import store
from deeplearning4j_tpu_torch.checkpoint.array_store import (
    CheckpointCorruptError,
    CheckpointError,
)
from deeplearning4j_tpu_torch.util.retry import with_retries

_STEP_RE = re.compile(r"^step_(\d+)$")

COUNTERS = ("dl4j_checkpoint_saves_total", "dl4j_checkpoint_restores_total",
            "dl4j_checkpoint_bytes_written_total",
            "dl4j_checkpoint_bytes_read_total", "dl4j_checkpoint_queue_depth",
            "restore_fallback")

_FAMILIES = {
    "dl4j_checkpoint_saves_total": _obs.metrics.counter(
        "dl4j_checkpoint_saves_total", "Committed checkpoint saves"),
    "dl4j_checkpoint_restores_total": _obs.metrics.counter(
        "dl4j_checkpoint_restores_total", "Checkpoint restores"),
    "dl4j_checkpoint_bytes_written_total": _obs.metrics.counter(
        "dl4j_checkpoint_bytes_written_total",
        "Array bytes captured into committed checkpoints"),
    "dl4j_checkpoint_bytes_read_total": _obs.metrics.counter(
        "dl4j_checkpoint_bytes_read_total",
        "Committed checkpoint bytes read by restores (manifest sizes)"),
}
_M_QUEUE = _obs.metrics.gauge(
    "dl4j_checkpoint_queue_depth",
    "In-flight async checkpoint writes (bounded to 1 by design)")


class BackgroundWrite:
    """One write off the caller's thread at a time. `start(snap, write)`
    runs `write()` on a daemon thread and holds `snap`, the host buffers
    it writes, until `flush`. `flush` waits for the write, drops `snap` on
    the caller's thread (pinned memory is freed through CUDA) and raises
    the write's error, once, if it had one."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._snap = None
        self._error: Optional[BaseException] = None

    def start(self, snap, write: Callable[[], None]) -> None:
        self.flush()

        def work():
            try:
                write()
            except BaseException as e:  # raised by the next flush()
                self._error = e

        self._snap = snap
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def busy(self) -> bool:
        """True while a write is running."""
        return self._thread is not None and self._thread.is_alive()

    def flush(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._snap = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 keep_every: int = 0, async_save: bool = True,
                 mesh=None, context=None, save_every: int = 0,
                 device="cuda"):
        if mesh is not None or context is not None:
            raise NotImplementedError(
                "CheckpointManager onto a mesh or a ParallelContext is not "
                "in the port yet (ROADMAP A.13)")
        self.directory = str(directory)
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every)
        self.async_save = bool(async_save)
        # `maybe_save` saves every `save_every` steps (0: never).
        self.save_every = int(save_every)
        self.device = device
        os.makedirs(self.directory, exist_ok=True)
        self._writes = BackgroundWrite()
        self._counts = {name: 0 for name in COUNTERS}
        self._timings = {}
        self.stats = MappingProxyType(self._counts)
        self.timings = MappingProxyType(self._timings)

    def _count(self, name: str, n=1) -> None:
        """Add `n` to this manager's count and to the registry's family."""
        self._counts[name] += n
        fam = _FAMILIES.get(name)
        if fam is not None:
            fam.inc(n)

    def _queue(self, depth: int) -> None:
        self._counts["dl4j_checkpoint_queue_depth"] = depth
        _M_QUEUE.set(depth)

    @contextlib.contextmanager
    def _span(self, name: str, **args):
        """The tracer's span `name`; a block that ends normally keeps its
        seconds in `timings`."""
        with _obs.tracer.span(name, cat="checkpoint", **args):
            t0 = time.perf_counter()
            yield
            self._timings[name] = time.perf_counter() - t0

    # ----------------------------------------------------------- discovery

    def step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def all_steps(self) -> List[int]:
        """Committed, validating steps, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if not m:
                continue
            try:
                store.verify_checkpoint(os.path.join(self.directory, name))
            except CheckpointError:
                continue
            steps.append(int(m.group(1)))
        return sorted(steps)

    def latest(self) -> Optional[int]:
        """Newest committed step (None if none): a newer damaged save never
        hides an older good one."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_path(self) -> Optional[str]:
        step = self.latest()
        return None if step is None else self.step_path(step)

    def candidate_steps(self) -> List[int]:
        """Every step-named directory, descending, unvalidated: the
        restore walk wants to see a damaged newest step, to warn of it."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps, reverse=True)

    # ---------------------------------------------------------------- save

    def save(self, net, step: Optional[int] = None) -> str:
        """Checkpoint `net` at `step` (default: its iteration). The snapshot
        is taken here; the write and commit run on the background thread
        unless `async_save` is False. Returns the (future) committed
        path."""
        self.flush()  # one write in flight; surface an earlier error
        step = int(net.iteration if step is None else step)
        with self._span("checkpoint.snapshot", step=step):
            snap = store.snapshot_net(net)
        nbytes = store.snapshot_nbytes(snap)
        path = self.step_path(step)

        def write_committed():
            # A transient storage error must not end training: retried
            # with backoff (`write_snapshot` clears its stale `.tmp`).
            with self._span("checkpoint.write", step=step, bytes=nbytes):
                with_retries(lambda: store.write_snapshot(snap, path),
                             retry_on=(OSError,),
                             describe=f"checkpoint write step {step}")
            self._count("dl4j_checkpoint_bytes_written_total", nbytes)
            self._count("dl4j_checkpoint_saves_total")
            self._apply_retention()

        def work():
            try:
                write_committed()
            finally:
                self._queue(0)

        if self.async_save:
            self._queue(1)
            self._writes.start(snap, work)
        else:
            write_committed()
        return path

    def maybe_save(self, net, step: Optional[int] = None) -> Optional[str]:
        """Save iff `save_every > 0` and the step is on the cadence. Step 0
        never saves."""
        step = int(net.iteration if step is None else step)
        if self.save_every <= 0 or step <= 0 or step % self.save_every:
            return None
        return self.save(net, step)

    def flush(self) -> None:
        """Wait for the in-flight save; raise its error, if any."""
        self._writes.flush()

    def _apply_retention(self) -> None:
        if self.keep_last <= 0:
            return
        steps = self.all_steps()
        keep = set(steps[-self.keep_last:])
        if self.keep_every > 0:
            keep.update(s for s in steps if s % self.keep_every == 0)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_path(s), ignore_errors=True)

    # ------------------------------------------------------------- restore

    def restore(self, step: Optional[int] = None, net=None,
                load_updater: bool = True):
        """Restore `step`, or the newest step, walking back past each
        damaged one (truncated chunk, missing COMMIT) with a
        RuntimeWarning and a `restore_fallback` count. A damaged step named
        explicitly raises `CheckpointCorruptError`. `net=None` builds the
        net on the manager's `device`."""
        self.flush()
        if step is not None:
            return self._restore_one(int(step), net, load_updater)
        candidates = self.candidate_steps()
        if not candidates:
            raise CheckpointError(
                f"no committed checkpoint under {self.directory}")
        last_err: Optional[BaseException] = None
        for cand in candidates:
            try:
                return self._restore_one(cand, net, load_updater)
            except CheckpointCorruptError as e:
                last_err = e
                warnings.warn(
                    f"checkpoint step {cand} failed corruption checks "
                    f"({e}); falling back to previous committed step",
                    RuntimeWarning, stacklevel=2)
                self._count("restore_fallback")
        raise CheckpointCorruptError(
            f"all {len(candidates)} checkpoint steps under "
            f"{self.directory} failed corruption checks") from last_err

    def _restore_one(self, step: int, net, load_updater: bool):
        path = self.step_path(step)
        # Verify first: a truncated chunk must surface as the clean error
        # the fallback walk routes around, before any tensor is written.
        manifest = store.verify_checkpoint(path)
        with self._span("checkpoint.restore", step=int(step)):
            result = store.restore_checkpoint(path, net=net,
                                              load_updater=load_updater,
                                              device=self.device)
        self._count("dl4j_checkpoint_bytes_read_total",
                    sum(manifest["files"].values()))
        self._count("dl4j_checkpoint_restores_total")
        return result
