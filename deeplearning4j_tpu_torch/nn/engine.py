"""What the two network engines share (`ComputationGraph` in `graph.py`,
`MultiLayerNetwork` in `multilayer.py`; the JAX package keeps a copy in
each): the device and precision policy, the params as leaf tensors and
their compute-dtype copy for inference, the per-layer updaters and
learning-rate schedules, the l1/l2 penalty, the backward and the in-place
update.

`_layer_confs` maps each layer's key (a graph vertex name, or `layer_i`)
to its conf, in the engine's update order.

- Params live on the engine's device at the policy's param dtype
  (`params_tree`, f32 leaf tensors that require grad). Training casts the
  leaves to the compute dtype inside autograd at each step, so gradients
  reach the f32 params as in the reference (f32 params, bf16 compute under
  `mixed_bfloat16`); the updater then changes the leaves in place (on the
  card one fused-update launch for all the Adam, Nesterovs or RMSProp
  layers of a step), and the step count stays on the host: a step issues
  no host sync.
- Inference reads ONE copy at the compute dtype, built by `init`, dropped
  by every training step and by `set_params`, and rebuilt at the next
  inference: an eager cast per forward would move the whole model every
  decode step, where the reference casts inside its jitted program.
- `params()` / `set_params()` are the reference's flat view: the layers in
  the engine's `_param_layer_order()` (MultiLayerNetwork: layer order; the
  graph: its layer vertices in topological order), then each layer's
  `param_shapes()` order. `updater_state_flat()` /
  `set_updater_state_flat()` are the flat updater view in the reference's
  leaf order (its `tree_leaves`: every dict's keys sorted, at every
  level). The model zip stores both.
- Construction refuses a base conf with no forward pass and a LoRA
  adapter (`nn/layers/__init__.py` `check_supported`), the adapter naming
  its ROADMAP item.
- The objective's extra terms are shared: an MoE layer's `_aux_loss`
  state entry leaves the state and joins the loss (`take_aux_loss`), and
  a `CenterLossOutputLayer` adds its center term and moves its class
  centers (`center_loss`).
- Listeners (`set_listeners`) get `on_epoch_start(net)`, then
  `iteration_done(net, iteration)` after every iteration, then
  `on_epoch_end(net)` (`optimize/listeners.py`); both engines call them
  where the reference's do.
- `_train_rng` is the reference's train-time RNG continuation, a
  `uint32[2]` threefry key that `init` sets to its `PRNGKey(seed ^
  0x5EED)` (`nn/prng.py`). `_next_rng` advances it where the reference's
  does, `key, sub = split(key)`: once per `fit` step (per tBPTT chunk),
  once per train-mode `output` or `feed_forward`. The forward gives each
  layer `LayerKey(sub, index)`, the reference's `fold_in(sub, index)`,
  from which its dropout draws are seeded (`nn/layers/common.py`). So a
  checkpoint's `rng` means the same in both packages, and a run resumed
  from one draws the masks of the uninterrupted run; the masks themselves
  are not JAX's.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels import fused_update
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import resolve_policy
from deeplearning4j_tpu_torch.nn.conf.layers import is_bias_param
from deeplearning4j_tpu_torch.nn.layers import check_supported
from deeplearning4j_tpu_torch.nn.prng import prng_key, split
from deeplearning4j_tpu_torch.ops import grad_norm as grad_norm_mod
from deeplearning4j_tpu_torch.ops import schedules as schedules_mod
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod


def to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def take_aux_loss(lstate, aux):
    """A layer's new state less its `_aux_loss` entry (an MoE layer's
    weighted load-balance loss), which is never kept as state; when `aux`
    is a dict the entry is added to `aux["aux_loss"]` (the reference sums
    them in layer, or topological, order)."""
    if not lstate or "_aux_loss" not in lstate:
        return lstate
    lstate = dict(lstate)
    term = lstate.pop("_aux_loss")
    if aux is not None:
        aux["aux_loss"] = aux.get("aux_loss", 0.0) + term
    return lstate


def center_loss(layer, feats, centers, labels, lmask, eb, loss_dtype):
    """A `CenterLossOutputLayer`'s term and its new centers (reference
    `multilayer.py:573-593`): with c the centers of each row's class (int
    labels, or the argmax of one-hot ones) and w each row's labels-mask
    weight (1 without a mask), the term 0.5 * lambda * sum_i w_i *
    ||feats_i - c_i||^2 / eb, differentiated through the layer's input
    `feats`; the centers move by alpha * sum_class(w * (c - feats)) / (1 +
    sum_class(w)), a state update outside autograd (`index_add_`)."""
    feats = feats.to(loss_dtype)
    b = labels.shape[0]
    cls = (labels.argmax(-1) if labels.is_floating_point()
           else labels.long())
    c = centers[cls]
    w = (torch.ones(b, dtype=loss_dtype, device=feats.device)
         if lmask is None else lmask.reshape(b, -1)[:, 0].to(loss_dtype))
    term = 0.5 * layer.lambda_ * (w * ((feats - c) ** 2).sum(-1)).sum() / eb
    with torch.no_grad():
        num = torch.zeros(layer.n_out, feats.shape[-1], dtype=loss_dtype,
                          device=feats.device).index_add_(
            0, cls, (c - feats) * w[:, None])
        cnt = torch.zeros(layer.n_out, dtype=torch.float32,
                          device=feats.device).index_add_(0, cls, w.float())
        new = centers - layer.alpha * num / (1.0 + cnt)[:, None]
    return term, new


class NetworkEngine:
    """Base of the engines (see module docstring)."""

    def __init__(self, global_conf, layer_confs, device):
        for name, layer in layer_confs.items():
            check_supported(name, layer)
        self.device = resolve_device(device)
        self._global = global_conf
        self._layer_confs = layer_confs
        self.dtype_policy = resolve_policy(global_conf)
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
        self.listeners: List = []
        # The fused update's packed kernel arguments per (kind, hyper)
        # group, reused while the params and state stay the same tensors
        # (`fused_update.apply_step`); emptied where they are replaced.
        self._update_tables: Dict[tuple, object] = {}

    @property
    def score_value(self) -> float:
        """Loss of the most recent iteration. Reading it syncs with the
        device; the training step itself never does."""
        return float("nan") if self._score is None else float(self._score)

    def _init_engine(self, params, updater_state, state, draw_order):
        """Fresh params from `global_conf.seed` (an explicit
        `torch.Generator`, drawn on the CPU layer by layer in `draw_order`,
        then moved), or the given `{key: {name: tensor}}` tree (see
        `interop.params_from_numpy`); the declared layer state (BatchNorm
        running statistics) fresh at the param dtype, or the given tree
        (`interop.state_from_numpy`); fresh updater state, or the given one
        (`interop.updater_state_from_numpy`)."""
        g = self._global
        pol = self.dtype_policy
        layers = self._layer_confs
        if params is None:
            gen = torch.Generator().manual_seed(int(g.seed))
            params = {name: params_mod.init_layer_params(layers[name], gen)
                      for name in draw_order}
        params_mod.check_params(layers, params)
        self.params_tree = params_mod.as_leaves(params, self.device,
                                                pol.param_dtype)
        self._update_tables.clear()
        self._compute_params = None
        self._compute_copy()
        # Declared (persistent) layer state, at the param dtype; the carried
        # recurrent and decode state is undeclared (nn/rnn_state.py).
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
        self._train_rng = prng_key(int(g.seed) ^ 0x5EED)
        self.rnn_clear_previous_state()

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def _iteration_done(self) -> None:
        self.iteration += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)

    def set_updater_state(self, updater_state) -> None:
        """Resume from `{"opt_state": {key: {field: {name: tensor}}},
        "iteration": n}` (`interop.updater_state_from_numpy`): the tree
        must match this engine's updaters field for field."""
        tree = updater_state["opt_state"]
        for name, own in self.opt_state.items():
            got = tree.get(name, {})
            want = {f: {k: tuple(t.shape) for k, t in s.items()}
                    for f, s in own.items()}
            have = {f: {k: tuple(t.shape) for k, t in s.items()}
                    for f, s in got.items()}
            if want != have:
                raise ValueError(f"updater state of {name!r}: want "
                                 f"{want}, got {have}")
            self.opt_state[name] = {
                f: {k: t.detach().to(self.device,
                                     self.dtype_policy.param_dtype, copy=True)
                    for k, t in s.items()} for f, s in got.items()}
        self._update_tables.clear()
        self.iteration = int(updater_state["iteration"])

    def _compute_copy(self):
        if self.params_tree is None:
            raise RuntimeError("call init() first")
        if self._compute_params is None:
            with torch.no_grad():
                self._compute_params = params_mod.cast_floating(
                    self.params_tree, self.dtype_policy.compute_dtype)
        return self._compute_params

    def _l1_l2_penalty(self, params):
        total = 0.0
        for name, layer in self._layer_confs.items():
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

    def _check_trainable(self, *refused) -> None:
        """Raise NotImplementedError, naming the ROADMAP item, for what
        `fit` does not run yet; `refused` adds engine-specific
        `(condition, what, item)` triples."""
        g = self._global
        checks = [
            (str(g.optimization_algo).lower()
             != "stochastic_gradient_descent",
             f"optimization_algo {g.optimization_algo!r} (solvers)", 10),
            (int(g.superstep_k or 0) > 1, "superstep training", 10),
            *refused]
        for name, layer in self._layer_confs.items():
            checks.append((bool(layer.frozen),
                           f"frozen layer {name!r} (transfer learning)", 12))
        for cond, what, item in checks:
            if cond:
                raise NotImplementedError(
                    f"fit: {what} is not in the port yet (ROADMAP A.{item})")

    def _next_rng(self) -> np.ndarray:
        """Advance the train key, `key, sub = split(key)`; the subkey seeds
        one train-mode forward's draws."""
        self._train_rng, sub = split(self._train_rng)
        return sub

    def _train_backward(self, loss):
        """`{key: {name: grad}}` of every leaf that requires grad (zeros
        for a leaf the loss does not reach, as jax.grad gives), each
        contiguous as the update kernel takes it: a convolution's kernel
        gradient comes back through the HWIO permute in whatever layout
        cuDNN or the CPU wrote it, and is copied only then."""
        names = [(v, k) for v, p in self.params_tree.items()
                 for k, t in p.items() if t.requires_grad]
        leaves = [self.params_tree[v][k] for v, k in names]
        with torch.inference_mode(False):
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (v, k), leaf, gr in zip(names, leaves, flat):
            grads.setdefault(v, {})[k] = (torch.zeros_like(leaf)
                                          if gr is None else gr.contiguous())
        return grads

    def _train_update(self, grads) -> None:
        with torch.no_grad():
            self._apply_updates(grads)
        self._compute_params = None  # the inference copy is stale now

    def _apply_updates(self, grads) -> None:
        """Per layer (reference `_train_step`): normalize, schedule, update,
        bias-rate factor, then params -= sign * deltas, in place. Layers
        whose updater has a fused body (Adam, Nesterovs, RMSProp) are
        gathered by (kind, hyper) and updated together by one
        `fused_update.apply_step` each (on the card one kernel launch over
        all their tensors, which writes the params too); the others take
        their updater's deltas here. The step is `self.iteration`, which a
        truncated-BPTT sequence advances once, after its last chunk."""
        g = self._global
        sign = 1.0 if g.minimize else -1.0
        step = self.iteration
        groups: Dict[tuple, list] = {}
        for name, layer in self._layer_confs.items():
            lgrads = grads.get(name)
            if not lgrads:
                continue
            lgrads = grad_norm_mod.normalize_layer_gradients(
                lgrads, layer.gradient_normalization,
                float(layer.gradient_normalization_threshold or 1.0))
            lr = self._schedules[name](step)
            base_lr = float(layer.learning_rate
                            if layer.learning_rate is not None
                            else g.learning_rate)
            bias_lr = float(layer.bias_learning_rate
                            if layer.bias_learning_rate is not None
                            else base_lr)
            factors = None
            if bias_lr != base_lr and base_lr != 0.0:
                factor = bias_lr / base_lr
                factors = {k: factor for k in lgrads if is_bias_param(k)}
            updater = self._updaters[name]
            if updater.fused is not None:
                groups.setdefault(updater.fused, []).append(
                    (name, fused_update.UpdateItem(
                        self.params_tree[name], self.opt_state[name], lgrads,
                        lr, factors)))
                continue
            st, deltas = updater.update(self.opt_state[name], lgrads, lr,
                                        step)
            fused_update.apply_deltas(self.params_tree[name], deltas,
                                      factors, sign)
            self.opt_state[name] = st
        for (kind, hyper), members in groups.items():
            states = fused_update.apply_step(
                kind, hyper, [item for _, item in members], step, sign,
                self._update_tables)
            for (name, _), st in zip(members, states):
                self.opt_state[name] = st

    # ------------------------------------------------------------ flat views

    def _param_layer_order(self) -> List[str]:
        raise NotImplementedError

    def _param_orders(self):
        return {k: list(layer.param_shapes())
                for k, layer in self._layer_confs.items()}

    def num_params(self) -> int:
        return int(sum(np.prod(s) for layer in self._layer_confs.values()
                       for s in layer.param_shapes().values()))

    def params(self) -> np.ndarray:
        """The flat 1-D param view (reference `Model.params()`)."""
        return params_mod.flatten_params(self.params_tree,
                                         self._param_layer_order(),
                                         self._param_orders())

    def set_params(self, flat) -> None:
        """Write a flat view (as `params()` gives it) into the params, in
        place; the inference copy is rebuilt at the next inference."""
        new = params_mod.unflatten_params(flat, self.params_tree,
                                          self._param_layer_order(),
                                          self._param_orders())
        with torch.no_grad():
            for lk, p in new.items():
                for k, a in p.items():
                    self.params_tree[lk][k].copy_(a)
        self._compute_params = None

    def _updater_leaves(self) -> List[torch.Tensor]:
        """The updater state's tensors in the reference's leaf order."""
        def walk(tree):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    yield from walk(tree[k])
            else:
                yield tree

        return list(walk(self.opt_state or {}))

    def updater_state_flat(self) -> np.ndarray:
        """The flat updater view (reference `updater_state_flat`: layer
        keys, state fields and param names each sorted)."""
        leaves = self._updater_leaves()
        if not leaves:
            return np.zeros((0,), np.float32)
        return torch.cat([t.detach().cpu().reshape(-1)
                          for t in leaves]).numpy()

    def set_updater_state_flat(self, flat) -> None:
        """Write a flat updater view, as `updater_state_flat` gives it, into
        the updater state (in place)."""
        leaves = self._updater_leaves()
        flat = torch.as_tensor(np.asarray(flat))
        want = sum(t.numel() for t in leaves)
        if flat.numel() != want:
            raise ValueError(f"flat updater state length {flat.numel()} != "
                             f"expected {want}")
        pos = 0
        with torch.no_grad():
            for t in leaves:
                n = t.numel()
                t.copy_(flat[pos:pos + n].reshape(t.shape))
                pos += n

    def clone(self):
        """A deep copy on the same device: params, layer state and updater
        state copied, never shared (reference `clone`)."""
        net = type(self)(copy.deepcopy(self.conf), device=self.device)
        if self.params_tree is not None:
            # init copies every tensor it is given.
            net.init(params=self.params_tree, state=self.state,
                     updater_state={"opt_state": self.opt_state,
                                    "iteration": self.iteration})
            net.epoch = self.epoch
            net._train_rng = self._train_rng.copy()
        return net

    def _declared_state(self):
        return {name: tuple(layer.state_shapes())
                for name, layer in self._layer_confs.items()}

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}
        self._rnn_pos = 0
