"""Score calculators (counterpart of
`deeplearning4j_tpu/earlystopping/scorecalc.py`; reference
`earlystopping/scorecalc/DataSetLossCalculator`)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetLossCalculator:
    """The loss over a DataSet or an iterator of them: the mean over
    examples (each batch's score weighted by its examples), or with
    `average=False` the sum of those weighted scores."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, net) -> float:
        it = self.iterator
        if hasattr(it, "reset"):
            it.reset()
        if isinstance(it, DataSet):
            return net.score(it)
        total, examples = 0.0, 0
        for ds in it:
            n = ds.num_examples()
            total += net.score(ds) * n
            examples += n
        if examples == 0:
            return float("nan")
        return total / examples if self.average else total
