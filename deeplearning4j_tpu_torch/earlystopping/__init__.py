"""Early stopping (counterpart of `deeplearning4j_tpu/earlystopping/`):
configuration, epoch and iteration termination conditions, the score
calculator, model savers and the trainer loop (reference
`trainer/BaseEarlyStoppingTrainer.java:76-100`).
"""

from deeplearning4j_tpu_torch.earlystopping.config import (  # noqa: F401
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
)
from deeplearning4j_tpu_torch.earlystopping.saver import (  # noqa: F401
    InMemoryModelSaver,
    LocalFileModelSaver,
)
from deeplearning4j_tpu_torch.earlystopping.scorecalc import (  # noqa: F401
    DataSetLossCalculator,
)
from deeplearning4j_tpu_torch.earlystopping.termination import (  # noqa: F401
    BestScoreEpochTerminationCondition,
    EpochTerminationCondition,
    InvalidScoreIterationTerminationCondition,
    IterationTerminationCondition,
    MaxEpochsTerminationCondition,
    MaxScoreIterationTerminationCondition,
    MaxTimeIterationTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
)
from deeplearning4j_tpu_torch.earlystopping.trainer import (  # noqa: F401
    EarlyStoppingTrainer,
)
