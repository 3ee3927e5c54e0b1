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
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.checkpoint.array_store import host_copies

MANIFEST = "manifest.json"
CONFIGURATION = "configuration.json"
COEFFICIENTS = "coefficients.bin"
UPDATER_STATE = "updaterState.bin"
EXTRA_STATE = "state.npz"


def save_model(net, path: Union[str, os.PathLike],
               save_updater: bool = True) -> None:
    """Write `net` (a MultiLayerNetwork or a ComputationGraph) to a model
    zip (reference `ModelSerializer.writeModel`)."""
    write_zip(path, **host_snapshot(net, save_updater))


def host_snapshot(net, save_updater: bool = True) -> Dict[str, Any]:
    """The zip's contents as owned host copies (`array_store.host_copies`),
    as `write_zip`'s keyword arguments: params in `params()` order, the
    updater state in `updater_state_flat()` order (None if `save_updater`
    is False or the net has none), the layer state by `"<layer>/<name>"`.
    The step after it changes none of them, so it may be written on
    another thread."""
    if net.params_tree is None:
        raise RuntimeError("the net has no params to save; call init() "
                           "first")
    params = [net.params_tree[lk][pn] for lk in net._param_layer_order()
              for pn in net._param_orders()[lk]]
    with_updater = save_updater and net.opt_state is not None
    updater = net._updater_leaves() if with_updater else []
    state = [(f"{lk}/{k}", v) for lk, sub in net.state.items()
             for k, v in sub.items()]
    hosts = host_copies(params + updater + [v for _, v in state])
    n_p, n_u = len(params), len(updater)
    return {
        "engine": type(net).__name__,
        "conf_json": net.conf.to_json(),
        "params": hosts[:n_p],
        "updater": hosts[n_p:n_p + n_u] if with_updater else None,
        "state": {k: h for (k, _), h in zip(state, hosts[n_p + n_u:])},
        "iteration": int(net.iteration),
        "epoch": int(net.epoch),
    }


def _flat64(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Host leaf copies as one little-endian float64 vector. A bf16 copy
    is raw `<u2` (`host_copies`): its bits are a float32's upper half."""
    parts = []
    for a in arrays:
        a = np.ascontiguousarray(a).reshape(-1)
        if a.dtype == np.dtype("<u2"):
            a = (a.astype("<u4") << 16).view("<f4")
        parts.append(a.astype("<f8"))
    return np.concatenate(parts) if parts else np.zeros((0,), "<f8")


def write_zip(path, engine: str, conf_json: str,
              params: Sequence[np.ndarray],
              updater: Optional[Sequence[np.ndarray]],
              state: Dict[str, np.ndarray], iteration: int, epoch: int,
              extra: Optional[Dict[str, bytes]] = None) -> None:
    """The zip's entries from host data (`host_snapshot`): the params' and
    (unless None) the updater state's leaves flattened in order and
    written as float64; the layer state as `"<layer>/<name>"` arrays;
    `extra` entries after them."""
    params = _flat64(params)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as z:
        z.writestr(MANIFEST, json.dumps({
            "format": "deeplearning4j_tpu/model-zip",
            "version": 1,
            "engine": engine,
            "param_dtype": "float64",
            "num_params": int(params.size),
            "iteration": int(iteration),
            "epoch": int(epoch),
        }))
        z.writestr(CONFIGURATION, conf_json)
        z.writestr(COEFFICIENTS, params.tobytes())
        if updater is not None:
            z.writestr(UPDATER_STATE, _flat64(updater).tobytes())
        if state:
            buf = io.BytesIO()
            np.savez(buf, **state)
            z.writestr(EXTRA_STATE, buf.getvalue())
        for name, data in (extra or {}).items():
            z.writestr(name, data)


def engine_classes():
    """`{engine name: (conf class, engine class)}`, the names the zip's
    manifest and the sharded checkpoint's meta give."""
    from deeplearning4j_tpu_torch.nn.conf.neural_net import (
        ComputationGraphConfiguration,
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return {"MultiLayerNetwork": (MultiLayerConfiguration,
                                  MultiLayerNetwork),
            "ComputationGraph": (ComputationGraphConfiguration,
                                 ComputationGraph)}


def load_model(path: Union[str, os.PathLike], load_updater: bool = True,
               device="cuda"):
    """The network of a model zip, on `device`: params, updater state
    (unless `load_updater` is False), declared layer state, iteration and
    epoch as saved (reference `ModelSerializer.restore*`, the engine read
    from the manifest)."""
    engines = engine_classes()
    with zipfile.ZipFile(path, "r") as z:
        manifest = json.loads(z.read(MANIFEST))
        engine = manifest.get("engine")
        if engine not in engines:
            raise ValueError(f"unknown engine {engine!r} in {MANIFEST}")
        conf_cls, net_cls = engines[engine]
        conf = conf_cls.from_json(z.read(CONFIGURATION).decode())
        net = net_cls(conf, device=device).init()
        _read_into(net, z, manifest, load_updater)
    return net


def load_into(net, path: Union[str, os.PathLike],
              load_updater: bool = True) -> None:
    """Write a model zip of `net`'s conf into `net`, in place: its param,
    updater-state and layer-state tensors stay the same objects."""
    with zipfile.ZipFile(path, "r") as z:
        _read_into(net, z, json.loads(z.read(MANIFEST)), load_updater)


def _read_into(net, z: zipfile.ZipFile, manifest: dict,
               load_updater: bool) -> None:
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
