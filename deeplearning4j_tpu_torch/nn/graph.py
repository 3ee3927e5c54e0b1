"""ComputationGraph, inference subset (counterpart of
`deeplearning4j_tpu/nn/graph.py:112-335,1110-1170`).

The DAG is walked in the conf's topological order, eagerly, under
`torch.inference_mode()`; there is no `fit` yet. Params live on the graph's
device at the policy's param dtype (`params_tree`), and the graph keeps ONE
copy at the compute dtype, built by `init`, that every forward reads: the
reference casts at use inside its jitted program, where XLA fuses the cast,
but an eager cast per forward would move the whole model (~86 MB at the
served width in bf16) every decode step. The numbers are the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import rnn_state as rnn_mod
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import resolve_policy
from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import OUTPUT_LAYER_TYPES, get_impl


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class ComputationGraph:
    """DAG network engine, inference subset (see module docstring)."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 device="cuda"):
        self.device = resolve_device(device)
        conf.validate()
        self.conf = conf
        self.topo_order = conf.topological_order()
        self.layer_vertices = {name: v for name, v in conf.vertices.items()
                               if isinstance(v, LayerVertex)}
        self.dtype_policy = resolve_policy(conf.global_conf)
        self.params_tree: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._compute_params = None
        self.state: Dict[str, Dict] = {}
        self._rnn_state: Dict[str, Dict] = {}
        self._rnn_pos = 0

    def init(self, params=None) -> "ComputationGraph":
        """Fresh params from `conf.global_conf.seed` (an explicit
        `torch.Generator`, drawn on the CPU in sorted vertex order, then
        moved), or the given `{vertex: {name: tensor}}` tree (see
        `interop.params_from_numpy`). Builds the compute-dtype copy."""
        pol = self.dtype_policy
        layers = {n: v.layer for n, v in self.layer_vertices.items()}
        if params is None:
            gen = torch.Generator().manual_seed(int(self.conf.global_conf.seed))
            params = {name: params_mod.init_layer_params(layers[name], gen)
                      for name in sorted(layers)}
        params_mod.check_params(layers, params)
        self.params_tree = {
            v: {k: a.to(self.device, pol.param_dtype)
                if a.is_floating_point() else a.to(self.device)
                for k, a in p.items()}
            for v, p in params.items()}
        self._compute_params = params_mod.cast_floating(self.params_tree,
                                                        pol.compute_dtype)
        # Declared (persistent) layer state: none of the slice's layers has
        # any; the carried decode state is undeclared (nn/rnn_state.py).
        self.state = {}
        self.rnn_clear_previous_state()
        return self

    # --------------------------------------------------------------- forward

    def _forward(self, state, inputs, keep_rnn_state: bool):
        """Walk the DAG; returns (outputs after the output layers'
        activation at the output dtype, new layer state)."""
        if self._compute_params is None:
            raise RuntimeError("call init() first")
        pol = self.dtype_policy
        params = self._compute_params
        values: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(self.conf.network_inputs):
            x = torch.as_tensor(inputs[i], device=self.device)
            # Floats run at the compute dtype (ids included, as in the
            # reference); integer ids pass through untouched.
            values[name] = (x.to(pol.compute_dtype) if x.is_floating_point()
                            else x)
        new_state: Dict[str, Dict] = {}
        for name in self.topo_order:
            vertex = self.conf.vertices[name]
            ins = [values[n] for n in self.conf.vertex_inputs[name]]
            if isinstance(vertex, LayerVertex):
                layer = vertex.layer
                out, lstate = get_impl(layer)(layer, params.get(name, {}),
                                              state.get(name, {}), ins[0])
                if lstate:
                    declared = set(layer.state_shapes())
                    keep = {k: v for k, v in lstate.items()
                            if k in declared or keep_rnn_state}
                    if keep:
                        new_state[name] = keep
                values[name] = out
            else:
                values[name] = vertex.apply(ins)
        outs = []
        for n in self.conf.network_outputs:
            o = values[n].to(pol.output_dtype)
            v = self.layer_vertices.get(n)
            if v is not None and type(v.layer).__name__ in OUTPUT_LAYER_TYPES:
                o = activations.resolve(v.layer.activation)(o)
            outs.append(o)
        return outs, new_state

    def forward_state(self, state, inputs):
        """One stateful forward for the decode steppers: `inputs` are device
        tensors, `state` the merged layer state; returns (outputs, new
        state) on the device."""
        with torch.inference_mode():
            return self._forward(state, inputs, keep_rnn_state=True)

    def output(self, *inputs) -> List[np.ndarray]:
        with torch.inference_mode():
            outs, _ = self._forward(self.state, inputs, keep_rnn_state=False)
            return [to_numpy(o) for o in outs]

    def output_single(self, *inputs) -> np.ndarray:
        return self.output(*inputs)[0]

    # ------------------------------------------------------------------ rnn

    def _declared_state(self):
        return {name: tuple(v.layer.state_shapes())
                for name, v in self.layer_vertices.items()}

    def rnn_time_step(self, *inputs) -> List[np.ndarray]:
        """Stateful inference: KV caches and positional cursors persist
        across calls. Accepts [b, f] (one step) or [b, t, f] per input."""
        arrs, squeeze = [], False
        for x in inputs:
            x = torch.as_tensor(x)
            if x.dim() == 2:
                x = x[:, None, :]
                squeeze = True
            arrs.append(x)
        self._rnn_pos = rnn_mod.check_decode_budget(
            self._rnn_pos, arrs[0].shape[1],
            rnn_mod.decode_capacity(v.layer
                                    for v in self.layer_vertices.values()))
        state = rnn_mod.merge_rnn_state(self.state, self._rnn_state)
        with torch.inference_mode():
            outs, new_state = self._forward(state, arrs, keep_rnn_state=True)
            self._rnn_state = rnn_mod.split_rnn_state(new_state,
                                                      self._declared_state())
            result = [to_numpy(o) for o in outs]
        return [o[:, 0] if squeeze and o.ndim == 3 else o for o in result]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}
        self._rnn_pos = 0
