"""Data containers, iterators and readers of the port.

The record readers and their iterators (`records.py`, the DataVec bridge)
are exported here; `dataset.py`, `iterators.py`, `staging.py` and
`builtin.py` are imported by module.
"""

from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    Cifar10DataSetIterator,
    CSVRecordReader,
    CSVSequenceRecordReader,
    CurvesDataSetIterator,
    ImageRecordReader,
    LFWDataSetIterator,
    RecordReader,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
    load_cifar10,
    load_curves,
)
