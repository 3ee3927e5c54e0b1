"""Termination conditions (counterpart of
`deeplearning4j_tpu/earlystopping/termination.py`; reference
`earlystopping/termination/`): the two bases, and MaxEpochs,
BestScoreEpoch, ScoreImprovementEpoch, MaxTime, MaxScore and
InvalidScore."""

from __future__ import annotations

import math
import time


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop as soon as the score is at or below a target value."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = float(best_expected_score)

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.best_expected_score


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = int(max_epochs_without_improvement)
        self.min_improvement = float(min_improvement)
        self.best = math.inf
        self.since = 0

    def initialize(self) -> None:
        self.best = math.inf
        self.since = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if score < self.best - self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since > self.patience


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = float(max_seconds)
        self._start = None

    def initialize(self) -> None:
        self._start = time.monotonic()

    def terminate(self, score: float) -> bool:
        if self._start is None:
            self._start = time.monotonic()
        return (time.monotonic() - self._start) > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Terminate if the score explodes above a bound."""

    def __init__(self, max_score: float):
        self.max_score = float(max_score)

    def terminate(self, score: float) -> bool:
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, score: float) -> bool:
        return math.isnan(score) or math.isinf(score)
