"""String enums of the configuration (counterpart of
`deeplearning4j_tpu/nn/conf/enums.py`): the two that ResNet's layers read,
`ConvolutionMode` and `PoolingType`, with the reference's values."""

from __future__ import annotations

import enum


class _StrEnum(str, enum.Enum):
    """String-valued enum: compares to strings, reads any case."""

    def __str__(self) -> str:
        return self.value

    @classmethod
    def of(cls, v):
        if v is None or isinstance(v, cls):
            return v
        return cls(str(v).lower())


class ConvolutionMode(_StrEnum):
    STRICT = "strict"
    TRUNCATE = "truncate"
    SAME = "same"


class PoolingType(_StrEnum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"
    NONE = "none"
