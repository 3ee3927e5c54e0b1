"""String enums of the configuration DSL (counterpart of
`deeplearning4j_tpu/nn/conf/enums.py`), with the reference's values.

A conf holds plain strings: `of()` reads any case and returns the member's
value, so `Updater.of("ADAM") == "adam"` and a conf's JSON is the
reference's. An unknown value raises ValueError.
"""

from __future__ import annotations

import enum


class _StrEnum(str, enum.Enum):
    """String-valued enum: compares to strings, reads any case."""

    def __str__(self) -> str:
        return self.value

    @classmethod
    def of(cls, v):
        """The value `v` names, as a plain lower-case string (None stays
        None)."""
        if v is None:
            return None
        if isinstance(v, cls):
            return v.value
        return cls(str(v).lower()).value


def plain(v):
    """A conf value as JSON writes it: a member of any of these enums as
    its value, anything else as it is."""
    return v.value if isinstance(v, _StrEnum) else v


class Activation(_StrEnum):
    SIGMOID = "sigmoid"
    TANH = "tanh"
    SOFTMAX = "softmax"
    IDENTITY = "identity"
    RELU = "relu"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    CUBE = "cube"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    SELU = "selu"
    GELU = "gelu"
    SWISH = "swish"


class LossFunction(_StrEnum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    SQUARED_LOSS = "squared_loss"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mean_absolute_percentage_error"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "mean_squared_logarithmic_error"
    XENT = "xent"
    MCXENT = "mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    COSINE_PROXIMITY = "cosine_proximity"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    POISSON = "poisson"
    RMSE_XENT = "rmse_xent"


class Updater(_StrEnum):
    SGD = "sgd"
    ADAM = "adam"
    ADAMAX = "adamax"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    NONE = "none"


class WeightInit(_StrEnum):
    ZERO = "zero"
    ONES = "ones"
    UNIFORM = "uniform"
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    XAVIER_LEGACY = "xavier_legacy"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMALIZED = "normalized"
    SIZE = "size"
    VI = "vi"
    DISTRIBUTION = "distribution"
    IDENTITY = "identity"


class GradientNormalization(_StrEnum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalizel2perlayer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalizel2perparamtype"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clipelementwiseabsolutevalue"
    CLIP_L2_PER_LAYER = "clipl2perlayer"
    CLIP_L2_PER_PARAM_TYPE = "clipl2perparamtype"


class OptimizationAlgorithm(_StrEnum):
    STOCHASTIC_GRADIENT_DESCENT = "stochastic_gradient_descent"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


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


class BackpropType(_StrEnum):
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncatedbptt"


class LearningRatePolicy(_StrEnum):
    NONE = "none"
    EXPONENTIAL = "exponential"
    INVERSE = "inverse"
    POLY = "poly"
    SIGMOID = "sigmoid"
    STEP = "step"
    TORCH_STEP = "torchstep"
    SCHEDULE = "schedule"
    SCORE = "score"
