"""Precision policy (counterpart of `deeplearning4j_tpu/nn/conf/dtype_policy.py`).

Answers what stored params are (`param_dtype`), what layer math runs in
(`compute_dtype`) and what `output()` returns (`output_dtype`). The legacy
`GlobalConf.dtype` string maps onto a preset as the reference maps it:
"bfloat16" means bf16 compute over f32 params, i.e. `mixed_bfloat16`. The
port has the presets its slices run, and float64 for CPU references (the
kernels take f32 and bf16); no preset needs loss scaling.
"""

from __future__ import annotations

import dataclasses

import torch

# name: (param, compute, output)
_PRESETS = {
    "float32": (torch.float32, torch.float32, torch.float32),
    "mixed_bfloat16": (torch.float32, torch.bfloat16, torch.float32),
    "float64": (torch.float64, torch.float64, torch.float64),
}
_ALIASES = {"f32": "float32", "fp32": "float32", "f64": "float64",
            "double": "float64"}


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    name: str = "float32"

    def __post_init__(self):
        name = _ALIASES.get(str(self.name), str(self.name))
        if name not in _PRESETS:
            raise ValueError(f"dtype policy {self.name!r} is not in the port; "
                             f"it has {sorted(_PRESETS)}")
        object.__setattr__(self, "name", name)

    @property
    def param_dtype(self) -> torch.dtype:
        return _PRESETS[self.name][0]

    @property
    def compute_dtype(self) -> torch.dtype:
        return _PRESETS[self.name][1]

    @property
    def output_dtype(self) -> torch.dtype:
        return _PRESETS[self.name][2]


def resolve_policy(global_conf) -> DtypePolicy:
    """An explicit `dtype_policy` (a preset name, or the reference's dict
    holding only a "name") wins; else the legacy `dtype` string."""
    explicit = getattr(global_conf, "dtype_policy", None)
    if explicit is not None:
        if isinstance(explicit, dict):
            extra = sorted(set(explicit) - {"name"})
            if extra:
                raise ValueError(f"dtype_policy fields {extra} are not in "
                                 "the port")
            explicit = explicit.get("name", "float32")
        return DtypePolicy(str(explicit))
    legacy = getattr(global_conf, "dtype", "float32")
    return DtypePolicy("mixed_bfloat16" if legacy == "bfloat16" else legacy)
