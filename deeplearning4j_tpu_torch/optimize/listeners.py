"""Training listeners (counterpart of
`deeplearning4j_tpu/optimize/listeners.py`): the reference's
IterationListener / TrainingListener hooks. Both engines' `fit` call
`on_epoch_start(net)`, `iteration_done(net, iteration)` after every
iteration, and `on_epoch_end(net)`. The checkpoint and failure listeners
are in `util/checkpoint.py` and `util/failure.py`.

Reading `net.score_value` waits for the step that made it: a listener that
reads it every iteration holds the card to the host's pace.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

import torch

logger = logging.getLogger("deeplearning4j_tpu_torch")


class IterationListener:
    """Base listener: every hook does nothing."""

    def iteration_done(self, model, iteration: int) -> None:
        pass

    def on_epoch_start(self, model) -> None:
        pass

    def on_epoch_end(self, model) -> None:
        pass


class ScoreIterationListener(IterationListener):
    """Report the score every `print_iterations` iterations."""

    def __init__(self, print_iterations: int = 10,
                 out: Optional[Callable[[str], None]] = None):
        self.print_iterations = max(1, int(print_iterations))
        self.out = out or logger.info

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.print_iterations == 0:
            self.out(f"Score at iteration {iteration} is {model.score_value}")


class PerformanceListener(IterationListener):
    """Batches (and, given `record_batch`, samples) per second over each
    report interval of `frequency` iterations. The card runs behind the
    host, so the clock alone measures how fast steps are issued;
    `sync=True` waits for the net's device before every reading (honest,
    but it stops the host from running ahead). An interval with no
    `record_batch` reports NaN samples/s."""

    def __init__(self, frequency: int = 1, report_score: bool = False,
                 out: Optional[Callable[[str], None]] = None,
                 sync: bool = False):
        self.frequency = max(1, int(frequency))
        self.report_score = report_score
        self.sync = bool(sync)
        self.out = out or logger.info
        self._last_time = None
        self._last_iter = 0
        self._samples_since = 0
        self.last_samples_per_sec = float("nan")
        self.last_batches_per_sec = float("nan")

    def record_batch(self, num_samples: int) -> None:
        self._samples_since += int(num_samples)

    def iteration_done(self, model, iteration: int) -> None:
        device = getattr(model, "device", None)
        if self.sync and device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration - self._last_iter < self.frequency:
            return
        dt = now - self._last_time
        batches = iteration - self._last_iter
        self.last_batches_per_sec = batches / dt if dt > 0 else float("nan")
        self.last_samples_per_sec = (
            self._samples_since / dt if self._samples_since and dt > 0
            else float("nan"))
        msg = (f"iteration {iteration}: {self.last_batches_per_sec:.2f} "
               "batches/sec" + (f", {self.last_samples_per_sec:.2f} "
                                "samples/sec" if self._samples_since else ""))
        if self.report_score:
            msg += f", score {model.score_value:.6f}"
        self.out(msg)
        self._last_time, self._last_iter = now, iteration
        self._samples_since = 0


class CollectScoresIterationListener(IterationListener):
    """Collect (iteration, score) every `frequency` iterations."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % self.frequency == 0:
            self.scores.append((iteration, model.score_value))


class ComposableIterationListener(IterationListener):
    """Pass every hook on to several listeners, in order."""

    def __init__(self, *listeners: IterationListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration: int) -> None:
        for listener in self.listeners:
            listener.iteration_done(model, iteration)

    def on_epoch_start(self, model) -> None:
        for listener in self.listeners:
            listener.on_epoch_start(model)

    def on_epoch_end(self, model) -> None:
        for listener in self.listeners:
            listener.on_epoch_end(model)
