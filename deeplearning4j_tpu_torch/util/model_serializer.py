"""The model zip (counterpart of `deeplearning4j_tpu/util/
model_serializer.py`, after the reference's `ModelSerializer`), the
reading half: `load_model` restores a zip the reference wrote.

A zip holds `manifest.json` (format, version, engine, iteration, epoch),
`configuration.json` (the conf's JSON), `coefficients.bin` (the flat
`params()` view, little-endian float64), optionally `updaterState.bin`
(the flat updater view, float64, in the reference's leaf order) and
`state.npz` (declared layer state as `"<layer>/<name>"` arrays: BatchNorm
running statistics).

`save_model` needs the conf's `to_json`, which comes with the config DSL
(ROADMAP A.2); until then it raises before it writes anything.
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
    raise NotImplementedError(
        "save_model writes the conf's to_json(), which is not in the port "
        "yet (ROADMAP A.2); nothing was written")


def load_model(path: Union[str, os.PathLike], load_updater: bool = True,
               device="cuda"):
    """A MultiLayerNetwork from a model zip, on `device`: params, updater
    state (unless `load_updater` is False), declared layer state,
    iteration and epoch as saved."""
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    with zipfile.ZipFile(path, "r") as z:
        manifest = json.loads(z.read(MANIFEST))
        engine = manifest.get("engine")
        if engine == "ComputationGraph":
            raise NotImplementedError(
                "load_model of a ComputationGraph zip: the port's graph has "
                "no flat params view yet (ROADMAP A.11)")
        if engine != "MultiLayerNetwork":
            raise ValueError(f"unknown engine {engine!r} in {MANIFEST}")
        conf = MultiLayerConfiguration.from_json(
            z.read(CONFIGURATION).decode())
        net = MultiLayerNetwork(conf, device=device).init()
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
