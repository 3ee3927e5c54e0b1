"""Weight distributions for `weight_init="distribution"` (counterpart of
`deeplearning4j_tpu/nn/conf/distributions.py`): Normal, Gaussian (the same
as Normal), Uniform and Binomial, drawn from an explicit
`torch.Generator`. The draws are not JAX's threefry stream; what matches
is the distribution. `to_dict` names the class under `@dist`, as the
reference writes it."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class Distribution:
    def sample(self, generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@dist"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d):
        if d is None:
            return None
        d = dict(d)
        kind = d.pop("@dist")
        cls = _DISTRIBUTIONS.get(kind)
        if cls is None:
            raise ValueError(f"unknown distribution {kind!r}; the port has "
                             f"{sorted(_DISTRIBUTIONS)}")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"{kind} has no fields {unknown}")
        return cls(**d)


@dataclass
class NormalDistribution(Distribution):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        return self.mean + self.std * torch.randn(
            tuple(shape), generator=generator, dtype=dtype)


@dataclass
class GaussianDistribution(NormalDistribution):
    """The reference's synonym of NormalDistribution."""


@dataclass
class UniformDistribution(Distribution):
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, generator, shape, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
        return self.lower + (self.upper - self.lower) * u


@dataclass
class BinomialDistribution(Distribution):
    number_of_trials: int = 1
    probability_of_success: float = 0.5

    def sample(self, generator, shape, dtype=torch.float32):
        u = torch.rand((int(self.number_of_trials),) + tuple(shape),
                       generator=generator)
        return (u < self.probability_of_success).sum(dim=0).to(dtype)


_DISTRIBUTIONS = {cls.__name__: cls for cls in (
    NormalDistribution, GaussianDistribution, UniformDistribution,
    BinomialDistribution)}
