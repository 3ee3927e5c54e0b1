"""Carry weights between the two packages as numpy.

`params_from_numpy` takes a params tree as the JAX package holds it
(`cg.params_tree` with every leaf turned into a numpy array: nested
`{vertex: {name: array}}`) and returns the port's tree, name for name, for
`ComputationGraph.init(params=...)`. The port checks names and shapes
against its conf there, so both packages compute the same function.
HWIO conv kernels travel as they are (the port keeps the layout); so do
a quantized tree's int8 weights and their f32 `__scale` companions
(`checkpoint/quantize.py`), at their own dtypes.
`state_from_numpy` carries declared layer state the same way (`cg.state`:
the BatchNorm running means and variances) for `init(state=...)`."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy-native view
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree: Mapping[str, Mapping[str, object]]
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    return {str(v): {str(k): _tensor(a) for k, a in p.items()}
            for v, p in tree.items()}


def state_from_numpy(tree: Mapping[str, Mapping[str, object]]
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    return params_from_numpy(tree)


def updater_state_from_numpy(opt_state: Mapping[str, object],
                             iteration: int) -> Dict[str, object]:
    """The reference's `opt_state` (numpy leaves) for `init(updater_state=
    ...)`: `{vertex: {field: {name: tensor}}}`, with its reserved keys, the
    f32 masters `_master` (`{vertex: {name: tensor}}`) and the loss-scale
    pair `_ls` (a tuple of two scalars)."""
    def node(fields):
        if isinstance(fields, Mapping):
            return {str(f): {str(k): _tensor(a) for k, a in leaves.items()}
                    for f, leaves in fields.items()}
        if isinstance(fields, (tuple, list)) and fields:
            return tuple(_tensor(a) for a in fields)
        return {}

    tree = {str(v): node(fields) for v, fields in opt_state.items()}
    return {"opt_state": tree, "iteration": int(iteration)}
