"""Early stopping configuration and result (counterpart of
`deeplearning4j_tpu/earlystopping/config.py`; reference
`earlystopping/EarlyStoppingConfiguration.java`, `EarlyStoppingResult.java`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class EarlyStoppingConfiguration:
    score_calculator: Any = None
    model_saver: Any = None
    epoch_termination_conditions: List[Any] = field(default_factory=list)
    iteration_termination_conditions: List[Any] = field(default_factory=list)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def score_calculator(self, sc):
            self._c.score_calculator = sc
            return self

        def model_saver(self, saver):
            self._c.model_saver = saver
            return self

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_termination_conditions = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_termination_conditions = list(conds)
            return self

        def save_last_model(self, v=True):
            self._c.save_last_model = bool(v)
            return self

        def evaluate_every_n_epochs(self, n):
            self._c.evaluate_every_n_epochs = int(n)
            return self

        def build(self):
            return self._c

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()


@dataclass
class EarlyStoppingResult:
    termination_reason: str = ""
    termination_details: str = ""
    score_vs_epoch: Dict[int, float] = field(default_factory=dict)
    best_model_epoch: int = -1
    best_model_score: float = float("inf")
    total_epochs: int = 0
    best_model: Any = None
