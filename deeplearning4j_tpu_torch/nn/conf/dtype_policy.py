"""Precision policy (counterpart of `deeplearning4j_tpu/nn/conf/dtype_policy.py`).

`DtypePolicy` is the conf's policy as the reference writes it: a preset
name, per-dtype overrides and the loss-scaling knobs, all strings and
numbers, so a conf that holds one round-trips through JSON (`to_dict`
writes the name and every field off its default).

`resolve_policy` turns a conf's globals into what the engines run:
`Precision`, the stored params' dtype (`param_dtype`), the dtype layer
math runs in (`compute_dtype`) and the dtype `output()` returns
(`output_dtype`). The legacy `GlobalConf.dtype` string maps onto a preset
as the reference maps it: "bfloat16" means bf16 compute over f32 params,
i.e. `mixed_bfloat16`. The port runs float32, mixed_bfloat16 and float64
(the CPU reference; the kernels take f32 and bf16). The f16 presets train
with dynamic loss scaling and the bf16-param preset keeps f32 master
copies: an engine given either raises NotImplementedError (ROADMAP A.7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

_CANONICAL = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "float64": "float64", "f64": "float64", "double": "float64",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "f16": "float16", "fp16": "float16",
    "mixed_bfloat16": "mixed_bfloat16",
    "mixed_float16": "mixed_float16",
}

# name: (param, compute, output, dynamic loss scaling)
_PRESETS = {
    "float32": ("float32", "float32", "float32", False),
    "float64": ("float64", "float64", "float64", False),
    "mixed_bfloat16": ("float32", "bfloat16", "float32", False),
    "mixed_float16": ("float32", "float16", "float32", True),
    "bfloat16": ("bfloat16", "bfloat16", "bfloat16", False),
    "float16": ("float16", "float16", "float16", True),
}

_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
_RUNS = ("float32", "mixed_bfloat16", "float64")


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """The reference's policy fields; unset overrides fall back to the
    preset `name` selects."""

    name: str = "float32"
    param_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    output_dtype: Optional[str] = None
    transfer_dtype: Optional[str] = None
    dynamic_loss_scale: Optional[bool] = None
    initial_loss_scale: float = 2.0 ** 15
    loss_scale_growth_interval: int = 2000
    loss_scale_growth_factor: float = 2.0
    loss_scale_backoff_factor: float = 0.5

    def __post_init__(self):
        name = _CANONICAL.get(str(self.name))
        if name is None:
            raise ValueError(f"unknown dtype policy {self.name!r}; presets: "
                             f"{sorted(_PRESETS)}")
        object.__setattr__(self, "name", name)

    def resolved(self):
        """(param, compute, output) dtype names after the overrides."""
        p, c, o, _ = _PRESETS[self.name]
        return (self.param_dtype or p, self.compute_dtype or c,
                self.output_dtype or o)

    @property
    def uses_loss_scaling(self) -> bool:
        if self.dynamic_loss_scale is not None:
            return bool(self.dynamic_loss_scale)
        return _PRESETS[self.name][3]

    @property
    def is_default(self) -> bool:
        """Full f32 with no knob set: a checkpoint's meta omits it."""
        return self == DtypePolicy()

    def to_dict(self) -> dict:
        d: dict = {"name": self.name}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name != "name" and v is not None and v != f.default:
                d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DtypePolicy":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"dtype_policy has no fields {unknown}")
        return cls(**d)

    @classmethod
    def of(cls, v: Any) -> "DtypePolicy":
        """A policy from a preset name, the reference's dict, or a
        policy."""
        if v is None:
            return cls()
        if isinstance(v, DtypePolicy):
            return v
        if isinstance(v, str):
            return cls(name=v)
        if isinstance(v, dict):
            return cls.from_dict(v)
        raise TypeError(f"cannot build a DtypePolicy from {type(v).__name__}")


@dataclasses.dataclass(frozen=True)
class Precision:
    """The dtypes an engine runs at, resolved from a policy."""

    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype


def conf_policy(global_conf) -> DtypePolicy:
    """The conf's policy: an explicit `dtype_policy` wins; else the legacy
    `dtype` string."""
    explicit = getattr(global_conf, "dtype_policy", None)
    if explicit is not None:
        return DtypePolicy.of(explicit)
    legacy = str(getattr(global_conf, "dtype", "float32"))
    return DtypePolicy("mixed_bfloat16" if legacy == "bfloat16" else legacy)


def resolve_policy(global_conf) -> Precision:
    """The dtypes of `conf_policy`. Raises NotImplementedError for a policy
    the port does not run."""
    pol = conf_policy(global_conf)
    param, compute, output = pol.resolved()
    if pol.uses_loss_scaling or "float16" in (param, compute, output):
        raise NotImplementedError(
            f"dtype policy {pol.name!r} trains with dynamic loss scaling, "
            "which is not in the port yet (ROADMAP A.7)")
    if pol.name not in _RUNS or (param, compute, output) != \
            _PRESETS[pol.name][:3] or pol.transfer_dtype is not None:
        raise NotImplementedError(
            f"dtype policy {pol.to_dict()} (bf16 params with f32 master "
            "copies, dtype overrides, a transfer dtype) is not in the port "
            "yet (ROADMAP A.7)")
    return Precision(pol.name, _TORCH[param], _TORCH[compute], _TORCH[output])
