"""Early stopping trainer.

Counterpart of `deeplearning4j_tpu/earlystopping/trainer.py` (reference
`earlystopping/trainer/BaseEarlyStoppingTrainer.java:76-100`):
loop epochs over the training iterator, score with the calculator every N
epochs, save best model, stop on any termination condition.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
)


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, net, train_iterator):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        result = EarlyStoppingResult()
        for cond in (cfg.epoch_termination_conditions
                     + cfg.iteration_termination_conditions):
            cond.initialize()

        epoch = 0
        while True:
            self.net.fit(self.train_iterator)
            result.total_epochs = epoch + 1

            # Iteration-level conditions checked on the train score after the
            # epoch (NaN/exploding-score guards, wall-clock budget).
            train_score = self.net.score_value
            iter_stop = None
            for cond in cfg.iteration_termination_conditions:
                if cond.terminate(train_score):
                    iter_stop = cond
                    break
            if iter_stop is not None:
                result.termination_reason = "IterationTerminationCondition"
                result.termination_details = type(iter_stop).__name__
                break

            if epoch % max(1, cfg.evaluate_every_n_epochs) == 0:
                score = (cfg.score_calculator.calculate_score(self.net)
                         if cfg.score_calculator else train_score)
                result.score_vs_epoch[epoch] = score
                if score < result.best_model_score:
                    result.best_model_score = score
                    result.best_model_epoch = epoch
                    if cfg.model_saver:
                        cfg.model_saver.save_best_model(self.net, score)
                last_score = score
            else:
                last_score = result.score_vs_epoch.get(
                    max(result.score_vs_epoch, default=0), train_score)
            if cfg.save_last_model and cfg.model_saver:
                cfg.model_saver.save_latest_model(self.net, last_score)

            # Epoch conditions run EVERY epoch (reference semantics), using
            # the most recent score for score-based conditions.
            epoch_stop = None
            for cond in cfg.epoch_termination_conditions:
                if cond.terminate(epoch, last_score):
                    epoch_stop = cond
                    break
            if epoch_stop is not None:
                result.termination_reason = "EpochTerminationCondition"
                result.termination_details = type(epoch_stop).__name__
                break
            epoch += 1

        if cfg.model_saver:
            result.best_model = cfg.model_saver.get_best_model()
        if result.best_model is None:
            result.best_model = self.net
        return result
