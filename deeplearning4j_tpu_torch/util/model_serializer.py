"""The model zip (counterpart of `deeplearning4j_tpu/util/
model_serializer.py`, after the reference's `ModelSerializer`), for both
engines, byte for byte the reference's layout:

- `manifest.json`: format, version, engine ("MultiLayerNetwork" or
  "ComputationGraph"), param dtype, number of params, iteration, epoch;
- `configuration.json`: the conf's `to_json()`;
- `coefficients.bin`: the flat `params()` view, little-endian float64;
- `updaterState.bin` (unless `save_updater` is False): the flat updater
  view in the reference's leaf order, float64;
- `state.npz`: declared layer state as `"<layer>/<name>"` arrays (the
  BatchNorm running statistics), when there is any.

A zip either package writes loads in the other. The port deflates at
zlib level 1, the reference at the default 6: the entries are the same
bytes, and level 1 writes float64 coefficients about five times faster
for a zip about a tenth larger.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Union

import numpy as np
import torch

MANIFEST = "manifest.json"
CONFIGURATION = "configuration.json"
COEFFICIENTS = "coefficients.bin"
UPDATER_STATE = "updaterState.bin"
EXTRA_STATE = "state.npz"


def save_model(net, path: Union[str, os.PathLike],
               save_updater: bool = True) -> None:
    """Write `net` (a MultiLayerNetwork or a ComputationGraph) to a model
    zip (reference `ModelSerializer.writeModel`)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    if net.params_tree is None:
        raise RuntimeError("save_model: the net has no params; call init() "
                           "first")
    kind = ("ComputationGraph" if isinstance(net, ComputationGraph)
            else "MultiLayerNetwork")
    params = net.params().astype("<f8")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as z:
        z.writestr(MANIFEST, json.dumps({
            "format": "deeplearning4j_tpu/model-zip",
            "version": 1,
            "engine": kind,
            "param_dtype": "float64",
            "num_params": int(params.size),
            "iteration": int(net.iteration),
            "epoch": int(net.epoch),
        }))
        z.writestr(CONFIGURATION, net.conf.to_json())
        z.writestr(COEFFICIENTS, params.tobytes())
        if save_updater and net.opt_state is not None:
            z.writestr(UPDATER_STATE,
                       net.updater_state_flat().astype("<f8").tobytes())
        if net.state:
            buf = io.BytesIO()
            np.savez(buf, **{f"{lk}/{k}": v.detach().cpu().numpy()
                             for lk, sub in net.state.items()
                             for k, v in sub.items()})
            z.writestr(EXTRA_STATE, buf.getvalue())


def load_model(path: Union[str, os.PathLike], load_updater: bool = True,
               device="cuda"):
    """The network of a model zip, on `device`: params, updater state
    (unless `load_updater` is False), declared layer state, iteration and
    epoch as saved (reference `ModelSerializer.restore*`, the engine read
    from the manifest)."""
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        ComputationGraphConfiguration,
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    engines = {"MultiLayerNetwork": (MultiLayerConfiguration,
                                     MultiLayerNetwork),
               "ComputationGraph": (ComputationGraphConfiguration,
                                    ComputationGraph)}
    with zipfile.ZipFile(path, "r") as z:
        manifest = json.loads(z.read(MANIFEST))
        engine = manifest.get("engine")
        if engine not in engines:
            raise ValueError(f"unknown engine {engine!r} in {MANIFEST}")
        conf_cls, net_cls = engines[engine]
        conf = conf_cls.from_json(z.read(CONFIGURATION).decode())
        net = net_cls(conf, device=device).init()
        names = z.namelist()
        net.set_params(np.frombuffer(z.read(COEFFICIENTS), dtype="<f8").copy())
        if load_updater and UPDATER_STATE in names:
            net.set_updater_state_flat(
                np.frombuffer(z.read(UPDATER_STATE), dtype="<f8").copy())
        if EXTRA_STATE in names:
            loaded = np.load(io.BytesIO(z.read(EXTRA_STATE)))
            with torch.no_grad():
                for key in loaded.files:
                    lk, k = key.split("/", 1)
                    if lk in net.state and k in net.state[lk]:
                        net.state[lk][k].copy_(torch.from_numpy(loaded[key]))
        net.iteration = int(manifest.get("iteration", 0))
        net.epoch = int(manifest.get("epoch", 0))
    return net
