"""ComputationGraph (counterpart of `deeplearning4j_tpu/nn/graph.py`):
inference, and `fit` with the plain SGD-family step.

The DAG is walked in the conf's topological order, eagerly. Params live on
the graph's device at the policy's param dtype (`params_tree`, f32 leaf
tensors that require grad).

- Training (`fit`) casts the leaves to the compute dtype inside autograd
  at each step, so gradients reach the f32 params as in the reference
  (f32 params, bf16 compute under `mixed_bfloat16`); the updater then
  changes the leaves in place, layer vertex by layer vertex, and the step
  count stays on the host: a step issues no host sync.
- Inference reads ONE copy at the compute dtype, built by `init`, dropped
  by every training step and rebuilt at the next inference: an eager cast per forward would move
  the whole model (~86 MB at the served width in bf16) every decode step,
  where the reference casts inside its jitted program.
- Declared layer state (the BatchNorm running statistics, `self.state`)
  is kept at the param dtype and never cast to the compute dtype: `fit` runs the layers in training mode (batch
  statistics) and keeps the new running statistics they return;
  `output` and `score` read the running statistics.

What `fit` does not run yet raises NotImplementedError naming its ROADMAP
item: dropout, solvers, truncated BPTT, superstep, frozen layers, feature
masks (f16 loss scaling never gets this far: the port's dtype policies are
float32, mixed_bfloat16 and float64).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import rnn_state as rnn_mod
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import resolve_policy
from deeplearning4j_tpu_torch.nn.conf.graph import LayerVertex
from deeplearning4j_tpu_torch.nn.conf.layers import is_bias_param
from deeplearning4j_tpu_torch.nn.conf.neural_net import (
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import OUTPUT_LAYER_TYPES, get_impl
from deeplearning4j_tpu_torch.ops import grad_norm as grad_norm_mod
from deeplearning4j_tpu_torch.ops import schedules as schedules_mod
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _as_mds(data, labels=None) -> MultiDataSet:
    if isinstance(data, MultiDataSet):
        return data
    if isinstance(data, DataSet):
        return MultiDataSet.from_dataset(data)
    return MultiDataSet(features=[data], labels=[labels])


class ComputationGraph:
    """DAG network engine (see module docstring)."""

    def __init__(self, conf: ComputationGraphConfiguration,
                 device="cuda"):
        self.device = resolve_device(device)
        conf.validate()
        self.conf = conf
        self.topo_order = conf.topological_order()
        self.layer_vertices = {name: v for name, v in conf.vertices.items()
                               if isinstance(v, LayerVertex)}
        self.dtype_policy = resolve_policy(conf.global_conf)
        # The loss runs in f32, in f64 under a float64 policy (reference).
        self._loss_dtype = (torch.float64
                            if self.dtype_policy.param_dtype == torch.float64
                            else torch.float32)
        self.params_tree: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._compute_params = None
        self.state: Dict[str, Dict] = {}
        self.opt_state: Optional[Dict[str, Dict]] = None
        self.iteration = 0
        self.epoch = 0
        self._score: Optional[torch.Tensor] = None
        self._rnn_state: Dict[str, Dict] = {}
        self._rnn_pos = 0

    @property
    def score_value(self) -> float:
        """Loss of the most recent iteration. Reading it syncs with the
        device; the training step itself never does."""
        return float("nan") if self._score is None else float(self._score)

    def init(self, params=None, updater_state=None,
             state=None) -> "ComputationGraph":
        """Fresh params from `conf.global_conf.seed` (an explicit
        `torch.Generator`, drawn on the CPU in sorted vertex order, then
        moved), or the given `{vertex: {name: tensor}}` tree (see
        `interop.params_from_numpy`); the declared layer state (BatchNorm
        running statistics) fresh at the param dtype, or the given tree
        (`interop.state_from_numpy`); fresh updater state, or the given one
        (`interop.updater_state_from_numpy`)."""
        g = self.conf.global_conf
        pol = self.dtype_policy
        layers = {n: v.layer for n, v in self.layer_vertices.items()}
        if params is None:
            gen = torch.Generator().manual_seed(int(g.seed))
            params = {name: params_mod.init_layer_params(layers[name], gen)
                      for name in sorted(layers)}
        params_mod.check_params(layers, params)
        self.params_tree = params_mod.as_leaves(params, self.device,
                                                pol.param_dtype)
        self._compute_params = None
        self._compute_copy()
        # Declared (persistent) layer state, at the param dtype (reference
        # graph.py:181-185); the carried decode state is undeclared
        # (nn/rnn_state.py).
        declared = {n: layer for n, layer in layers.items()
                    if layer.state_shapes()}
        if state is None:
            state = {n: params_mod.init_layer_state(layer)
                     for n, layer in declared.items()}
        params_mod.check_state(declared, state)
        self.state = {n: {k: a.detach().to(self.device, pol.param_dtype,
                                           copy=True)
                          for k, a in state[n].items()} for n in declared}
        self._updaters, self._schedules = {}, {}
        for name, layer in layers.items():
            def pick(field):
                own = getattr(layer, field)
                return own if own is not None else getattr(g, field)

            self._updaters[name] = updaters_mod.create(
                pick("updater"), momentum=pick("momentum"),
                adam_mean_decay=pick("adam_mean_decay"),
                adam_var_decay=pick("adam_var_decay"), rho=pick("rho"),
                rms_decay=pick("rms_decay"), epsilon=pick("epsilon"))
            self._schedules[name] = schedules_mod.make_schedule(
                float(pick("learning_rate")), g.lr_policy,
                g.lr_policy_decay_rate, g.lr_policy_power, g.lr_policy_steps,
                g.max_num_iterations, g.lr_schedule)
        with torch.no_grad():
            self.opt_state = {name: self._updaters[name].init(
                self.params_tree[name]) for name in layers}
        if updater_state is not None:
            self.set_updater_state(updater_state)
        self.rnn_clear_previous_state()
        return self

    def set_updater_state(self, updater_state) -> None:
        """Resume from `{"opt_state": {vertex: {field: {name: tensor}}},
        "iteration": n}` (`interop.updater_state_from_numpy`): the tree
        must match this graph's updaters field for field."""
        tree = updater_state["opt_state"]
        for name, own in self.opt_state.items():
            got = tree.get(name, {})
            want = {f: {k: tuple(t.shape) for k, t in s.items()}
                    for f, s in own.items()}
            have = {f: {k: tuple(t.shape) for k, t in s.items()}
                    for f, s in got.items()}
            if want != have:
                raise ValueError(f"updater state of vertex {name!r}: want "
                                 f"{want}, got {have}")
            self.opt_state[name] = {
                f: {k: t.detach().to(self.device,
                                     self.dtype_policy.param_dtype, copy=True)
                    for k, t in s.items()} for f, s in got.items()}
        self.iteration = int(updater_state["iteration"])

    # --------------------------------------------------------------- forward

    def _compute_copy(self):
        if self.params_tree is None:
            raise RuntimeError("call init() first")
        if self._compute_params is None:
            with torch.no_grad():
                self._compute_params = params_mod.cast_floating(
                    self.params_tree, self.dtype_policy.compute_dtype)
        return self._compute_params

    def _forward(self, params, state, inputs, keep_rnn_state: bool,
                 train: bool = False):
        """Walk the DAG; returns (the output vertices' raw values at the
        compute dtype, new layer state). `train` selects batch statistics
        (and their running-stat update) over the running ones."""
        cdt = self.dtype_policy.compute_dtype
        values: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(self.conf.network_inputs):
            x = torch.as_tensor(inputs[i], device=self.device)
            # Floats run at the compute dtype (ids included, as in the
            # reference); integer ids pass through untouched.
            values[name] = x.to(cdt) if x.is_floating_point() else x
        new_state: Dict[str, Dict] = {}
        for name in self.topo_order:
            vertex = self.conf.vertices[name]
            ins = [values[n] for n in self.conf.vertex_inputs[name]]
            if isinstance(vertex, LayerVertex):
                layer = vertex.layer
                out, lstate = get_impl(layer)(layer, params.get(name, {}),
                                              state.get(name, {}), ins[0],
                                              train=train)
                if lstate:
                    declared = set(layer.state_shapes())
                    keep = {k: v for k, v in lstate.items()
                            if k in declared or keep_rnn_state}
                    if keep:
                        new_state[name] = keep
                values[name] = out
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

    def _l1_l2_penalty(self, params):
        total = 0.0
        for name, v in self.layer_vertices.items():
            layer = v.layer
            l1, l2 = float(layer.l1 or 0.0), float(layer.l2 or 0.0)
            if (l1 == 0.0 and l2 == 0.0) or name not in params:
                continue
            for wk in layer.weight_param_keys():
                if wk not in params[name]:
                    continue
                w = params[name][wk].to(self._loss_dtype)
                if l2:
                    total = total + 0.5 * l2 * (w * w).sum()
                if l1:
                    total = total + l1 * w.abs().sum()
        return total

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
        g = self.conf.global_conf

        def refuse(what, item):
            raise NotImplementedError(
                f"fit: {what} is not in the port yet (ROADMAP A.{item})")

        if str(g.optimization_algo).lower() != "stochastic_gradient_descent":
            refuse(f"optimization_algo {g.optimization_algo!r} (solvers)", 10)
        if str(self.conf.backprop_type).lower() == "truncatedbptt":
            refuse("truncated BPTT", 8)
        if int(g.superstep_k or 0) > 1:
            refuse("superstep training", 10)
        for name, v in self.layer_vertices.items():
            rate = v.layer.dropout
            if rate is not None and 0.0 < float(rate) < 1.0:
                refuse(f"dropout={rate} on {name!r}", 4)
            if v.layer.frozen:
                refuse(f"frozen layer {name!r} (transfer learning)", 12)

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
            if hasattr(data, "reset"):
                data.reset()
            items = data
        for item in items:
            mds = _as_mds(item)
            for _ in range(max(1, int(self.conf.global_conf.iterations))):
                self._fit_one(mds)
        self.epoch += 1
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
        self.iteration += 1

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

    def _train_backward(self, loss):
        """`{vertex: {name: grad}}` of every leaf that requires grad (zeros
        for a leaf the loss does not reach, as jax.grad gives)."""
        names = [(v, k) for v, p in self.params_tree.items()
                 for k, t in p.items() if t.requires_grad]
        leaves = [self.params_tree[v][k] for v, k in names]
        with torch.inference_mode(False):
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (v, k), leaf, gr in zip(names, leaves, flat):
            grads.setdefault(v, {})[k] = (torch.zeros_like(leaf)
                                          if gr is None else gr)
        return grads

    def _train_update(self, grads) -> None:
        with torch.no_grad():
            self._apply_updates(grads)
        self._compute_params = None  # the inference copy is stale now

    def _apply_updates(self, grads) -> None:
        """Per layer vertex (reference `_train_step` :664-690): normalize,
        schedule, update, bias-rate factor, then params -= sign * deltas."""
        g = self.conf.global_conf
        sign = 1.0 if g.minimize else -1.0
        step = self.iteration
        for name, v in self.layer_vertices.items():
            layer = v.layer
            lgrads = grads.get(name)
            if not lgrads:
                continue
            lgrads = grad_norm_mod.normalize_layer_gradients(
                lgrads, layer.gradient_normalization,
                float(layer.gradient_normalization_threshold or 1.0))
            lr = self._schedules[name](step)
            st, deltas = self._updaters[name].update(self.opt_state[name],
                                                     lgrads, lr, step)
            base_lr = float(layer.learning_rate
                            if layer.learning_rate is not None
                            else g.learning_rate)
            bias_lr = float(layer.bias_learning_rate
                            if layer.bias_learning_rate is not None
                            else base_lr)
            if bias_lr != base_lr and base_lr != 0.0:
                factor = bias_lr / base_lr
                deltas = {k: (d * factor if is_bias_param(k) else d)
                          for k, d in deltas.items()}
            for k, p in self.params_tree[name].items():
                if k in deltas:
                    p.sub_(deltas[k]) if sign > 0 else p.add_(deltas[k])
            self.opt_state[name] = st

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
            outs, new_state = self._forward(self._compute_copy(), state,
                                            arrs, keep_rnn_state=True)
            self._rnn_state = rnn_mod.split_rnn_state(new_state,
                                                      self._declared_state())
            result = [to_numpy(o) for o in self._finish(outs)]
        return [o[:, 0] if squeeze and o.ndim == 3 else o for o in result]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}
        self._rnn_pos = 0
