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

- Features masks (`MultiDataSet.features_masks`, `output(...,
  features_masks=)`, one per network input, `_as_mask_list`) travel
  with the values: through a vertex's preprocessor, layers
  (`nn/layers/__init__.py` `mask_after`: global pooling consumes one) and
  vertices as the reference's `_forward_fn` carries them (`LastTimeStep`
  reads its `mask_array_input`'s mask or its input's and emits none,
  `DuplicateToTimeSeries` takes its `input_name`'s, every other vertex
  its first input's). An output's mask is its loss mask where the labels
  bring none.
- Dropout and DropConnect draw in `fit` (a new key per step) and in
  `output(train=True)`, the vertex at topological position i drawing from
  `LayerKey(key, i)` (`engine.py`).
- The loss adds each `CenterLossOutputLayer` output's center term (and a
  training step moves its centers) and the MoE vertices' load-balance
  terms, summed in topological order, undivided by the batch
  (`engine.py` `take_aux_loss`, `center_loss`).

What `fit` does not run yet raises NotImplementedError naming its ROADMAP
item: solvers, truncated BPTT, superstep, frozen layers (f16 loss scaling
never gets this far: the port's dtype policies are float32,
mixed_bfloat16 and float64).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import maybe_reset
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import rnn_state as rnn_mod
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre_mod
from deeplearning4j_tpu_torch.nn.conf.graph import (
    DuplicateToTimeSeriesVertex,
    LastTimeStepVertex,
    LayerVertex,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.engine import (
    NetworkEngine,
    center_loss,
    take_aux_loss,
    to_numpy,
)
from deeplearning4j_tpu_torch.nn.layers import (
    OUTPUT_LAYER_TYPES,
    get_impl,
    mask_after,
)
from deeplearning4j_tpu_torch.nn.prng import LayerKey


def _as_mds(data, labels=None) -> MultiDataSet:
    if isinstance(data, MultiDataSet):
        return data
    if isinstance(data, DataSet):
        return MultiDataSet.from_dataset(data)
    return MultiDataSet(features=[data], labels=[labels])


def _as_mask_list(masks):
    """None when no entry is present, else the list with its None entries
    (reference `_as_mask_list`, graph.py:104-109)."""
    if masks is None or not any(m is not None for m in masks):
        return None
    return list(masks)


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
                 train: bool = False, fmasks=None, key=None, aux=None):
        """Walk the DAG; returns (the output vertices' raw values at the
        compute dtype, new layer state, the outputs' masks). `train`
        selects batch statistics (and their running-stat update) over the
        running ones; `key` (a train forward's subkey) gives the vertex at
        topological position i its draws' `LayerKey(key, i)`. A dict as
        `aux` collects the MoE vertices' `aux_loss` and each center-loss
        vertex's input and centers (by `name:` suffixed keys)."""
        cdt = self.dtype_policy.compute_dtype
        values: Dict[str, torch.Tensor] = {}
        masks: Dict[str, Optional[torch.Tensor]] = {}
        for i, name in enumerate(self.conf.network_inputs):
            # Floats run at the compute dtype (ids included, as in the
            # reference); integer ids pass through untouched.
            values[name] = pre_mod.apply_uint8_policy(
                torch.as_tensor(inputs[i], device=self.device),
                self._uint8_policies[name], cdt)
            masks[name] = (None if fmasks is None or fmasks[i] is None
                           else torch.as_tensor(fmasks[i],
                                                device=self.device))
        new_state: Dict[str, Dict] = {}
        for vi, name in enumerate(self.topo_order):
            vertex = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            ins = [values[n] for n in in_names]
            in_masks = [masks[n] for n in in_names]
            if isinstance(vertex, LayerVertex):
                layer, x, mask = vertex.layer, ins[0], in_masks[0]
                if vertex.preprocessor is not None:
                    x, mask = vertex.preprocessor(x, mask)
                if aux is not None and type(layer).__name__ == \
                        "CenterLossOutputLayer":
                    aux[f"center_loss_input:{name}"] = x
                    aux[f"centers:{name}"] = state.get(name, {}).get(
                        "centers")
                out, lstate = get_impl(layer)(
                    layer, params.get(name, {}), state.get(name, {}), x,
                    train=train, mask=mask,
                    rng=None if key is None else LayerKey(key, vi))
                lstate = take_aux_loss(lstate, aux)
                if lstate:
                    declared = set(layer.state_shapes())
                    keep = {k: v for k, v in lstate.items()
                            if k in declared or keep_rnn_state}
                    if keep:
                        new_state[name] = keep
                values[name] = out
                masks[name] = mask_after(layer, mask)
            elif isinstance(vertex, DuplicateToTimeSeriesVertex):
                values[name] = vertex.apply(
                    ins, time_steps=values[vertex.input_name].shape[1])
                masks[name] = masks.get(vertex.input_name)
            elif isinstance(vertex, LastTimeStepVertex):
                m = (masks.get(vertex.mask_array_input)
                     if vertex.mask_array_input else in_masks[0])
                values[name] = vertex.apply(ins, [m])
                masks[name] = None
            else:
                values[name] = vertex.apply(ins, in_masks)
                masks[name] = in_masks[0] if in_masks else None
        outs = self.conf.network_outputs
        return ([values[n] for n in outs], new_state,
                [masks.get(n) for n in outs])

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
            outs, new_state, _ = self._forward(self._compute_copy(), state,
                                               inputs, keep_rnn_state=True)
            return self._finish(outs), new_state

    def output(self, *inputs, train: bool = False,
               features_masks=None) -> List[np.ndarray]:
        """Forward (reference `output`, graph.py:1110); `train=True` runs
        the layers in training mode, dropout drawn from a new key."""
        key = self._next_rng() if train else None
        with torch.inference_mode():
            outs, _, _ = self._forward(self._compute_copy(), self.state,
                                       inputs, keep_rnn_state=False,
                                       train=train,
                                       fmasks=_as_mask_list(features_masks),
                                       key=key)
            return [to_numpy(o) for o in self._finish(outs)]

    def output_single(self, *inputs, **kw) -> np.ndarray:
        return self.output(*inputs, **kw)[0]

    # ------------------------------------------------------------------ loss

    def _loss_from_outputs(self, params, outs, labels, lmasks, omasks,
                           aux):
        """Score of the raw outputs (reference `_loss_from_outputs`): each
        output layer's loss in the loss dtype, summed over entries and
        divided by the minibatch (a center-loss output's center term over
        the same divisor), the MoE vertices' `aux_loss` undivided, plus
        the l1/l2 penalty over the first divisor; and the state the step
        moves (the centers). A sequence output with no labels mask takes
        its features mask as the loss mask."""
        total, extra = 0.0, {}
        for i, name in enumerate(self.conf.network_outputs):
            v = self.layer_vertices.get(name)
            if v is None or type(v.layer).__name__ not in OUTPUT_LAYER_TYPES:
                raise ValueError(f"Network output {name!r} is not an output "
                                 "layer")
            layer = v.layer
            lmask = lmasks[i] if lmasks is not None else None
            if lmask is None and omasks[i] is not None and outs[i].dim() == 3:
                lmask = omasks[i]
            eb = losses_mod.effective_batch_size(labels[i], lmask)
            if i == 0:
                eb0 = eb
            total = total + losses_mod.score(
                layer.loss_function, labels[i], outs[i].to(self._loss_dtype),
                layer.activation, lmask, average=False) / eb
            if f"center_loss_input:{name}" in aux:
                term, centers = center_loss(
                    layer, aux[f"center_loss_input:{name}"],
                    aux[f"centers:{name}"], labels[i], lmask, eb,
                    self._loss_dtype)
                total = total + term
                extra[name] = {"centers": centers}
        if "aux_loss" in aux:
            total = total + aux["aux_loss"]
        return total + self._l1_l2_penalty(params) / eb0, extra

    def _device_arrays(self, arrays):
        if arrays is None or not any(a is not None for a in arrays):
            return None
        return [None if a is None else torch.as_tensor(a, device=self.device)
                for a in arrays]

    def score(self, data, labels=None) -> float:
        """Loss of the current params on one batch (syncs)."""
        mds = _as_mds(data, labels)
        aux = {}
        with torch.inference_mode():
            outs, _, omasks = self._forward(
                self._compute_copy(), self.state, mds.features,
                keep_rnn_state=False,
                fmasks=_as_mask_list(mds.features_masks), aux=aux)
            return float(self._loss_from_outputs(
                self.params_tree, outs, self._device_arrays(mds.labels),
                self._device_arrays(mds.labels_masks), omasks, aux)[0])

    def evaluate(self, iterator, top_n: int = 1) -> Evaluation:
        """Classification evaluation of the first output over a DataSet,
        a MultiDataSet or an iterable of them, under their features and
        labels masks (reference `evaluate`, graph.py:1184)."""
        ev = Evaluation(top_n=top_n)
        maybe_reset(iterator)
        if isinstance(iterator, (DataSet, MultiDataSet)):
            iterator = [iterator]
        for item in iterator:
            mds = _as_mds(item)
            out = self.output(*mds.features,
                              features_masks=mds.features_masks)[0]
            lmask = mds.labels_masks[0] if mds.labels_masks else None
            ev.eval(mds.labels[0], out, mask=lmask)
        return ev

    # ------------------------------------------------------------------- fit

    def _check_trainable(self) -> None:
        super()._check_trainable(
            (str(self.conf.backprop_type).lower() == "truncatedbptt",
             "truncated BPTT on ComputationGraph", 18))

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
            aux = {}
            outs, new_state, omasks = self._forward(
                params, self.state, mds.features, keep_rnn_state=False,
                train=True, fmasks=_as_mask_list(mds.features_masks),
                key=self._next_rng(), aux=aux)
            loss, extra = self._loss_from_outputs(
                self.params_tree, outs, self._device_arrays(mds.labels),
                self._device_arrays(mds.labels_masks), omasks, aux)
        for name, s in extra.items():
            new_state.setdefault(name, {}).update(s)
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
            outs, new_state, _ = self._forward(self._compute_copy(), state,
                                               arrs, keep_rnn_state=True)
            self._rnn_state = rnn_mod.split_rnn_state(new_state,
                                                      self._declared_state())
            result = [to_numpy(o) for o in self._finish(outs)]
        return [o[:, 0] if squeeze and o.ndim == 3 else o for o in result]
