"""ComputationGraph (counterpart of `deeplearning4j_tpu/nn/graph.py`):
inference, and `fit` with the plain SGD-family step.

The DAG is walked in the conf's topological order, eagerly: a layer vertex
runs its input preprocessor, then its layer; every other vertex is its
conf's `apply` (`DuplicateToTimeSeriesVertex` takes its length from the
sequence `input_name` names). A uint8 network input is read by the wire
policy of the layers it feeds (`nn/conf/preprocessors.py`). Params, their
inference copy, the updaters, the in-place update and the flat views
(`params()` over the layer vertices in topological order) are the
engines' shared machinery (`engine.py`).

- `fit` calls the listeners (`set_listeners`) as the reference's does:
  `on_epoch_start`, `iteration_done(net, iteration)` after every step
  (`iterations` steps a batch), `on_epoch_end` (reference `:758-805`,
  `:1103-1106`).
- Declared layer state (the BatchNorm running statistics, `self.state`)
  is kept at the param dtype and never cast to the compute dtype: `fit`
  runs the layers in training mode (batch statistics) and keeps the new
  running statistics they return; `output` and `score` read the running
  statistics.

What `fit` does not run yet raises NotImplementedError naming its ROADMAP
item: dropout, solvers, truncated BPTT, superstep, frozen layers, feature
masks (f16 loss scaling never gets this far: the port's dtype policies are
float32, mixed_bfloat16 and float64).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import maybe_reset
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import rnn_state as rnn_mod
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre_mod
from deeplearning4j_tpu_torch.nn.conf.graph import (
    DuplicateToTimeSeriesVertex,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.engine import NetworkEngine, to_numpy
from deeplearning4j_tpu_torch.nn.layers import OUTPUT_LAYER_TYPES, get_impl


def _as_mds(data, labels=None) -> MultiDataSet:
    if isinstance(data, MultiDataSet):
        return data
    if isinstance(data, DataSet):
        return MultiDataSet.from_dataset(data)
    return MultiDataSet(features=[data], labels=[labels])


class ComputationGraph(NetworkEngine):
    """DAG network engine (see module docstring)."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 device="cuda"):
        conf.validate()
        self.conf = conf
        self.topo_order = conf.topological_order()
        self.layer_vertices = {name: v for name, v in conf.vertices.items()
                               if isinstance(v, LayerVertex)}
        super().__init__(conf.global_conf,
                         {n: v.layer for n, v in self.layer_vertices.items()},
                         device)
        # Each network input's uint8 policy, voted by the vertices it feeds.
        self._uint8_policies = {
            name: pre_mod.resolve_uint8_policy(
                getattr(conf.vertices[v], "layer", None)
                for v, ins in conf.vertex_inputs.items() if name in ins)
            for name in conf.network_inputs}

    def init(self, params=None, updater_state=None,
             state=None) -> "ComputationGraph":
        """Params, declared state and updater state, fresh (drawn in sorted
        vertex order) or given: see `NetworkEngine._init_engine`."""
        self._init_engine(params, updater_state, state,
                          sorted(self._layer_confs))
        return self

    # --------------------------------------------------------------- forward

    def _forward(self, params, state, inputs, keep_rnn_state: bool,
                 train: bool = False):
        """Walk the DAG; returns (the output vertices' raw values at the
        compute dtype, new layer state). `train` selects batch statistics
        (and their running-stat update) over the running ones."""
        cdt = self.dtype_policy.compute_dtype
        values: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(self.conf.network_inputs):
            # Floats run at the compute dtype (ids included, as in the
            # reference); integer ids pass through untouched.
            values[name] = pre_mod.apply_uint8_policy(
                torch.as_tensor(inputs[i], device=self.device),
                self._uint8_policies[name], cdt)
        new_state: Dict[str, Dict] = {}
        for name in self.topo_order:
            vertex = self.conf.vertices[name]
            ins = [values[n] for n in self.conf.vertex_inputs[name]]
            if isinstance(vertex, LayerVertex):
                layer, x = vertex.layer, ins[0]
                if vertex.preprocessor is not None:
                    x, _ = vertex.preprocessor(x)
                out, lstate = get_impl(layer)(layer, params.get(name, {}),
                                              state.get(name, {}), x,
                                              train=train)
                if lstate:
                    declared = set(layer.state_shapes())
                    keep = {k: v for k, v in lstate.items()
                            if k in declared or keep_rnn_state}
                    if keep:
                        new_state[name] = keep
                values[name] = out
            elif isinstance(vertex, DuplicateToTimeSeriesVertex):
                values[name] = vertex.apply(
                    ins, time_steps=values[vertex.input_name].shape[1])
            else:
                values[name] = vertex.apply(ins)
        return [values[n] for n in self.conf.network_outputs], new_state

    def _finish(self, outs):
        """Outputs at the output dtype, after the output layers'
        activation."""
        final = []
        for n, o in zip(self.conf.network_outputs, outs):
            o = o.to(self.dtype_policy.output_dtype)
            v = self.layer_vertices.get(n)
            if v is not None and type(v.layer).__name__ in OUTPUT_LAYER_TYPES:
                o = activations.resolve(v.layer.activation)(o)
            final.append(o)
        return final

    def forward_state(self, state, inputs):
        """One stateful forward for the decode steppers: `inputs` are device
        tensors, `state` the merged layer state; returns (outputs, new
        state) on the device."""
        with torch.inference_mode():
            outs, new_state = self._forward(self._compute_copy(), state,
                                            inputs, keep_rnn_state=True)
            return self._finish(outs), new_state

    def output(self, *inputs) -> List[np.ndarray]:
        with torch.inference_mode():
            outs, _ = self._forward(self._compute_copy(), self.state, inputs,
                                    keep_rnn_state=False)
            return [to_numpy(o) for o in self._finish(outs)]

    def output_single(self, *inputs) -> np.ndarray:
        return self.output(*inputs)[0]

    # ------------------------------------------------------------------ loss

    def _loss_from_outputs(self, params, outs, labels, lmasks):
        """Score of the raw outputs (reference `_loss_from_outputs`): each
        output layer's loss in the loss dtype, summed over entries and
        divided by the minibatch, plus the l1/l2 penalty over the first
        divisor."""
        total = 0.0
        for i, name in enumerate(self.conf.network_outputs):
            v = self.layer_vertices.get(name)
            if v is None or type(v.layer).__name__ not in OUTPUT_LAYER_TYPES:
                raise ValueError(f"Network output {name!r} is not an output "
                                 "layer")
            layer = v.layer
            lmask = lmasks[i] if lmasks is not None else None
            eb = losses_mod.effective_batch_size(labels[i], lmask)
            if i == 0:
                eb0 = eb
            total = total + losses_mod.score(
                layer.loss_function, labels[i], outs[i].to(self._loss_dtype),
                layer.activation, lmask, average=False) / eb
        return total + self._l1_l2_penalty(params) / eb0

    def _device_arrays(self, arrays):
        if arrays is None or not any(a is not None for a in arrays):
            return None
        return [None if a is None else torch.as_tensor(a, device=self.device)
                for a in arrays]

    def score(self, data, labels=None) -> float:
        """Loss of the current params on one batch (syncs)."""
        mds = _as_mds(data, labels)
        self._check_no_feature_masks(mds)
        with torch.inference_mode():
            outs, _ = self._forward(self._compute_copy(), self.state,
                                    mds.features, keep_rnn_state=False)
            return float(self._loss_from_outputs(
                self.params_tree, outs, self._device_arrays(mds.labels),
                self._device_arrays(mds.labels_masks)))

    # ------------------------------------------------------------------- fit

    def _check_trainable(self) -> None:
        super()._check_trainable(
            (str(self.conf.backprop_type).lower() == "truncatedbptt",
             "truncated BPTT on ComputationGraph", 18))

    @staticmethod
    def _check_no_feature_masks(mds) -> None:
        if mds.features_masks and any(m is not None
                                      for m in mds.features_masks):
            raise NotImplementedError(
                "features masks (masked attention) are not in the port yet "
                "(ROADMAP A.9)")

    def fit(self, data, labels=None) -> "ComputationGraph":
        """Train on a DataSet, a MultiDataSet or an iterable of those, or
        on `features, labels` arrays (reference `ComputationGraph.fit`)."""
        if self.params_tree is None:
            self.init()
        self._check_trainable()
        if labels is not None or isinstance(data, (DataSet, MultiDataSet)):
            items = [_as_mds(data, labels)]
        else:
            items = data
        maybe_reset(items)
        for listener in self.listeners:
            listener.on_epoch_start(self)
        for item in items:
            mds = _as_mds(item)
            for _ in range(max(1, int(self.conf.global_conf.iterations))):
                self._fit_one(mds)
        self.epoch += 1
        for listener in self.listeners:
            listener.on_epoch_end(self)
        return self

    def _fit_one(self, mds: MultiDataSet) -> None:
        """One step in three parts (each a method, so a profiler can wrap
        them on the instance): forward + loss, backward, update."""
        self._check_no_feature_masks(mds)
        loss, new_state = self._train_forward(mds)
        grads = self._train_backward(loss)
        self._train_update(grads)
        for n, s in new_state.items():
            self.state[n] = {**self.state.get(n, {}), **s}
        self._score = loss.detach()
        self._iteration_done()

    def _train_forward(self, mds):
        """The loss, recorded by autograd from the f32 leaves through their
        compute-dtype cast, and the new layer state (BatchNorm running
        statistics, moved on detached batch statistics)."""
        with torch.inference_mode(False), torch.enable_grad():
            params = params_mod.cast_floating(self.params_tree,
                                              self.dtype_policy.compute_dtype)
            outs, new_state = self._forward(params, self.state, mds.features,
                                            keep_rnn_state=False, train=True)
            loss = self._loss_from_outputs(
                self.params_tree, outs, self._device_arrays(mds.labels),
                self._device_arrays(mds.labels_masks))
        return loss, new_state

    # ------------------------------------------------------------- params io

    def _param_layer_order(self):
        """The reference's `_param_vertex_order`: layer vertices in
        topological order."""
        return [n for n in self.topo_order if n in self.layer_vertices]


    # ------------------------------------------------------------------ rnn

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
            outs, new_state = self._forward(self._compute_copy(), state,
                                            arrs, keep_rnn_state=True)
            self._rnn_state = rnn_mod.split_rnn_state(new_state,
                                                      self._declared_state())
            result = [to_numpy(o) for o in self._finish(outs)]
        return [o[:, 0] if squeeze and o.ndim == 3 else o for o in result]
