"""What the two network engines share (`ComputationGraph` in `graph.py`,
`MultiLayerNetwork` in `multilayer.py`; the JAX package keeps a copy in
each): the device and precision policy, the params as leaf tensors and
their compute-dtype copy for inference, the per-layer updaters and
learning-rate schedules, the l1/l2 penalty, the backward and the in-place
update.

`_layer_confs` maps each layer's key (a graph vertex name, or `layer_i`)
to its conf, in the engine's update order.

- Params live on the engine's device at the policy's param dtype
  (`params_tree`, leaf tensors that require grad). Training casts the
  leaves to the compute dtype inside autograd at each step
  (`params.prep_params`), so gradients reach the stored params as in the
  reference; the updater then changes the leaves in place (on the card
  one fused-update launch for all the Adam, Nesterovs or RMSProp layers
  of a step), and the step count stays on the host: a step issues no host
  sync.
- Precision policies (`nn/conf/dtype_policy.py`, reference `graph.py:
  164-226, 607-760`). Under params stored in bf16 or f16 the updater
  works on f32 master copies, `opt_state["_master"]` (`{vertex: {name:
  f32}}`, drawn or given at f32 and stored at the param dtype as their
  cast), with f32 updater and layer state; each step updates the master
  and writes its cast into the stored params (on the card in the same
  launch). Under dynamic loss scaling the backward runs on `loss *
  scale`, the gradients come back as `astype(f32) / scale`, one device
  bool says whether all of them are finite, and a step whose gradients
  are not leaves params, masters, updater and layer state as they were
  (a device select; the fused update's skip flag on the card) while the
  scale backs off; `loss_scale_growth_interval` finite steps in a row
  grow it. `(scale, good)` is `opt_state["_ls"]`, two f32 device
  scalars updated by device ops: no step reads them back.
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
- Fine-tuning (`nn/transfer.py`, `nn/lora.py`; reference graph.py:204-215,
  606-741). `init` builds the frozen spec from the layer confs (`frozen`,
  `lora_rank`): frozen leaves are stored with `requires_grad=False`, so
  the backward takes no gradient of them and row 9 never sees them; the
  updater state covers the trainable leaves only (a fully frozen layer's
  entry is `()`); under low-precision params the masters of frozen leaves
  stay beside the trained ones, unchanged. Frozen layers still run in
  training mode, so BatchNorm's running statistics move as the
  reference's do. A LoRA layer's weights reach the forward as `W + scale
  * (A @ B)` (`params.prep_layer_params`), so the factors train through
  the same backward.
- Post-training int8 params (`checkpoint/quantize.py`: a weight with a
  `__scale` companion) serve, and train only frozen (LoRA over an int8
  base): `fit` refuses an int8 leaf that would be trained.
- `output(..., params=tree)` and the decode steppers' overrides run a
  tree of the same structure in place of the net's own (an adapter-merged
  serving tree, `serving/host.py`): `_params_for` prepares it for that
  call only, from the inference copy where its leaves are the net's, and
  never reads or fills the cache.
- The objective's extra terms are shared: an MoE layer's `_aux_loss`
  state entry leaves the state and joins the loss (`take_aux_loss`), and
  a `CenterLossOutputLayer` adds its center term and moves its class
  centers (`center_loss`).
- Listeners (`set_listeners`) get `on_epoch_start(net)`, then
  `iteration_done(net, iteration)` after every iteration, then
  `on_epoch_end(net)` (`optimize/listeners.py`); both engines call them
  where the reference's do. A listener with `requires_training_stats`
  turns on the stats step (reference graph.py:1201-1205): each step then
  fills `last_training_stats`, `{layer: {param: {grad_mm, update_mm,
  param_mm}}}`, the means of |normalized gradient|, |applied delta, bias
  factor included| and |new param| (reference multilayer.py:759-770),
  device scalars until read. The stats step updates every layer through
  its updater's per-layer seam (on the card row 9's deltas mode, then
  `d * factor` and `p -= d`, which the kernel's apply mode equals bit for
  bit), so its params are the plain step's.
- Solvers (`optimization_algo` LBFGS, conjugate gradient, line gradient
  descent; `_fit_solver`, reference multilayer.py:969-995): each batch is
  minimized over the flat params in the reference's flat order (layer
  keys sorted, then param names sorted) for `iterations` solver
  iterations by `optimize/solvers.py`, on the engine's deterministic
  objective (`_objective`: no dropout, BatchNorm's running statistics,
  the forward the gradient checks use too); the iteration advances by
  `iterations`, the listeners hear once a batch, the stats are cleared.
  Masters and loss scaling refuse, as in the reference.
- Superstep (`superstep_k`, or `DL4J_TPU_SUPERSTEP_K`, which sets K and
  picks no implementation; `_superstep_k`, reference multilayer.py:886-
  907): `fit` over an iterator stacks K batches of one signature into a
  block (`datasets/iterators.py` `SuperbatchIterator`, cached on the base
  iterator) and trains it as K steps at once (`_fit_superstep`): on the
  card K train steps captured as one CUDA graph and replayed
  (`nn/superstep.py`), on the CPU the K steps in a loop; then the K
  scores fan out to the listeners, one iteration each. K is 0 (per batch)
  under a stats listener, `iterations > 1`, truncated BPTT and solvers.
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
- Observability (reference graph.py:57-92, 769, 813-835): each engine
  module resolves its families once at import (`EngineMetrics`: the
  iteration, epoch, dispatch-seconds, host->device-bytes, capture-cache
  and input-wait series under its `engine` label). `fit` runs in a
  `graph.fit` / `mln.fit` span and times each iterator-next
  (`_fit_items`); each dispatch (`_observed_dispatch`) runs under
  `observability.iteration_span`, counts its host bytes, observes its
  host seconds, records a flight-ring step (a superstep's with its `k` and
  K losses), and on an exception records a crash bundle and re-raises.
  The first dispatch of a batch signature on the card records the
  program's device memory (`memory.program_memory`). None of it reads a
  device value, and none of it runs inside a captured graph.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import observability as _obs
from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.datasets import iterators as iterators_mod
from deeplearning4j_tpu_torch.datasets import staging
from deeplearning4j_tpu_torch.observability import memory as _mem
from deeplearning4j_tpu_torch.kernels import fused_update
from deeplearning4j_tpu_torch.nn import lora as lora_mod
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import superstep as superstep_mod
from deeplearning4j_tpu_torch.nn import transfer as transfer_mod
from deeplearning4j_tpu_torch.nn.conf.dtype_policy import resolve_policy
from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.conf.layers import is_bias_param
from deeplearning4j_tpu_torch.nn.layers import check_supported
from deeplearning4j_tpu_torch.nn.prng import prng_key, split
from deeplearning4j_tpu_torch.ops import grad_norm as grad_norm_mod
from deeplearning4j_tpu_torch.ops import schedules as schedules_mod
from deeplearning4j_tpu_torch.ops import updaters as updaters_mod
from deeplearning4j_tpu_torch.optimize import solvers as solvers_mod

# `opt_state` keys that are no vertex: the f32 masters and the loss-scale
# pair (reference `multilayer.py:107`).
RESERVED_OPT_KEYS = ("_master", "_ls")


class EngineMetrics:
    """One engine's series (reference graph.py:57-92), its children
    resolved once: `engine` is "graph" or "mln"."""

    def __init__(self, engine: str):
        reg = _obs.metrics
        self.engine = engine
        self.iters = reg.counter(
            "dl4j_train_iterations_total", "Completed training iterations",
            label_names=("engine",)).labels(engine=engine)
        self.epochs = reg.counter(
            "dl4j_train_epochs_total", "Completed fit() epochs",
            label_names=("engine",)).labels(engine=engine)
        self._dispatch = reg.histogram(
            "dl4j_step_dispatch_seconds",
            "Host time to dispatch one staged batch (async — completion "
            "is NOT awaited; see dl4j_step_latency_seconds from "
            "StepProfiler for settled latency); `k` = train iterations "
            "fused into the dispatch (superstep)",
            label_names=("engine", "k"))
        self._dispatch_k = {1: self._dispatch.labels(engine=engine, k="1")}
        self.h2d = reg.counter(
            "dl4j_host_to_device_bytes_total",
            "Host-resident bytes staged to device with training batches",
            label_names=("engine",)).labels(engine=engine)
        self.jit_hit = reg.counter(
            "dl4j_jit_cache_hits_total", "Engine jit-program cache hits",
            label_names=("engine",)).labels(engine=engine)
        self.jit_miss = reg.counter(
            "dl4j_jit_cache_misses_total",
            "Engine jit-program cache misses (a new program will "
            "trace+compile)",
            label_names=("engine",)).labels(engine=engine)
        self.input_wait = reg.histogram(
            "dl4j_input_wait_seconds",
            "Host seconds blocked in iterator-next waiting for the next "
            "batch (input starvation; the device is idle while this "
            "accrues)",
            label_names=("source",)).labels(source=engine)

    def dispatch_observe(self, k: int, seconds: float) -> None:
        child = self._dispatch_k.get(k)
        if child is None:  # few distinct k a process: children cached
            child = self._dispatch.labels(engine=self.engine, k=str(k))
            self._dispatch_k[k] = child
        child.observe(seconds)


_BATCH_PARTS = ("features", "labels", "features_mask", "labels_mask",
                "features_masks", "labels_masks")


def batch_host_nbytes(item, device) -> int:
    """The bytes of a batch container's host-resident parts: what its
    dispatch copies to `device` (`observability.host_nbytes`)."""
    return _obs.host_nbytes(*(getattr(item, n, None) for n in _BATCH_PARTS),
                            device=device)


def dispatch_signature(item) -> tuple:
    """The container type, K and the parts' shapes and dtypes of one
    dispatched batch: a new signature is a new program (its first
    dispatch builds plans or captures a graph)."""
    def sig(a):
        if a is None:
            return None
        if isinstance(a, (list, tuple)):
            return tuple(sig(x) for x in a)
        return (tuple(a.shape), str(a.dtype))
    return (type(item).__name__, int(getattr(item, "k", 1)),
            *(sig(getattr(item, n, None)) for n in _BATCH_PARTS))


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

    # The context of the superstep steps being warmed up or captured
    # (`nn/superstep.py`): `_next_rng` has it wrap each step key, and the
    # fused update takes its scalar slots. None otherwise.
    _step_ctx = None
    # The engine's series (`EngineMetrics`), set by each engine class.
    _metrics: EngineMetrics = None

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
        self._frozen_spec: Dict[str, frozenset] = {}
        self._compute_params = None
        self.state: Dict[str, Dict] = {}
        self.opt_state: Optional[Dict[str, Dict]] = None
        self.iteration = 0
        self.epoch = 0
        self._score: Optional[torch.Tensor] = None
        self._rnn_state: Dict[str, Dict] = {}
        self._rnn_pos = 0
        self.listeners: List = []
        self._collect_stats = False
        self.last_training_stats: Dict[str, Dict] = {}
        # The fused update's packed kernel arguments per (kind, hyper)
        # group, reused while the params and state stay the same tensors
        # (`fused_update.apply_step`); emptied where they are replaced.
        self._update_tables: Dict[tuple, object] = {}
        # Observability: the last iterator-next wait, the K losses of the
        # last superstep dispatch, the batch signatures dispatched so far.
        self._last_input_wait: Optional[float] = None
        self._superstep_losses = None
        self._programs_seen: set = set()

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
            # The adapter leaves draw from a stream of their own.
            lora_gen = torch.Generator().manual_seed(int(g.seed) ^ 0x10A)
            params = {name: params_mod.init_layer_params(
                layers[name], gen, lora_generator=lora_gen)
                for name in draw_order}
        params_mod.check_params(layers, params)
        # What does not train (`nn/transfer.py`): {} for an ordinary net.
        self._frozen_spec = transfer_mod.frozen_spec(
            ((n, layers[n]) for n in draw_order), params)
        # Low-precision params keep f32 masters: the given (or drawn)
        # values at f32, the stored params their cast (reference init).
        master = (params_mod.as_leaves(params, self.device, torch.float32,
                                       grad=False)
                  if pol.low_precision_params else None)
        self.params_tree = params_mod.as_leaves(
            params, self.device, pol.param_dtype, frozen=self._frozen_spec)
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
        self.state = {n: {k: a.detach().to(self.device, pol.state_dtype,
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
        base = self.params_tree if master is None else master
        spec = self._frozen_spec
        trainable = transfer_mod.split_tree(base, spec)[0] if spec else base
        with torch.no_grad():
            self.opt_state = {
                name: (() if name in spec and not trainable[name]
                       else self._updaters[name].init(trainable[name]))
                for name in layers}
        # The reserved keys (never vertex names, reference graph.py:218).
        if master is not None:
            self.opt_state["_master"] = master
        if pol.loss_scaling:
            self.opt_state["_ls"] = tuple(
                torch.tensor(v, dtype=torch.float32, device=self.device)
                for v in (pol.initial_loss_scale, 0.0))
        if updater_state is not None:
            self.set_updater_state(updater_state)
        self._train_rng = prng_key(int(g.seed) ^ 0x5EED)
        self.rnn_clear_previous_state()

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        self._collect_stats = any(
            getattr(lst, "requires_training_stats", False)
            for lst in listeners)
        return self

    def _iteration_done(self) -> None:
        self.iteration += 1
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)

    def set_updater_state(self, updater_state) -> None:
        """Resume from `{"opt_state": {key: {field: {name: tensor}}},
        "iteration": n}` (`interop.updater_state_from_numpy`): the tree
        must match this engine's updaters field for field (a fully frozen
        layer's `()` an empty entry)."""
        tree = updater_state["opt_state"]
        sdt = self.dtype_policy.state_dtype
        for name in RESERVED_OPT_KEYS:
            if name in tree and name in self.opt_state:
                self._set_reserved(name, tree[name])
        for name, own in self.opt_state.items():
            if name in RESERVED_OPT_KEYS:
                continue
            got = tree.get(name, {})
            if isinstance(own, tuple):  # a fully frozen layer: no state
                if got:
                    raise ValueError(f"updater state of frozen {name!r}: "
                                     f"want none, got {sorted(got)}")
                continue
            want = {f: {k: tuple(t.shape) for k, t in s.items()}
                    for f, s in own.items()}
            have = {f: {k: tuple(t.shape) for k, t in s.items()}
                    for f, s in got.items()}
            if want != have:
                raise ValueError(f"updater state of {name!r}: want "
                                 f"{want}, got {have}")
            self.opt_state[name] = {
                f: {k: t.detach().to(self.device, sdt, copy=True)
                    for k, t in s.items()} for f, s in got.items()}
        self._update_tables.clear()
        self.iteration = int(updater_state["iteration"])

    def _set_reserved(self, key, value) -> None:
        """`opt_state[key]` for a reserved key from a given tree: the
        masters `{vertex: {name: tensor}}` or the `(scale, good)` pair."""
        if key == "_ls":
            self.opt_state["_ls"] = tuple(
                torch.as_tensor(v).detach().to(self.device, torch.float32,
                                               copy=True).reshape(())
                for v in value)
            return
        own = self.opt_state["_master"]
        for v, p in own.items():
            for k, t in p.items():
                got = value[v][k]
                if tuple(got.shape) != tuple(t.shape):
                    raise ValueError(f"master of {v}/{k}: want "
                                     f"{tuple(t.shape)}, got "
                                     f"{tuple(got.shape)}")
                own[v][k] = torch.as_tensor(got).detach().to(
                    self.device, torch.float32, copy=True)

    def _compute_copy(self):
        if self.params_tree is None:
            raise RuntimeError("call init() first")
        if self._compute_params is None:
            with torch.no_grad():
                self._compute_params = self._prep(self.params_tree)
        return self._compute_params

    def _prep(self, params):
        """The params as the forward reads them: cast, or dequantized, to
        the compute dtype (`params.prep_layer_params`)."""
        return params_mod.prep_params(params, self.dtype_policy.compute_dtype,
                                      self._layer_confs)

    def _params_for(self, params=None):
        """The compute-dtype tree a forward reads for `params`, a tree of
        the params' structure (an adapter-merged serving tree): None gives
        the cached inference copy. A layer whose leaves are all the net's
        own takes the inference copy's; a layer that adds adapter leaves
        over a base without them is its inference copy plus each delta
        (the same values as preparing it whole); any other layer is
        prepared whole. Nothing is cached: an adapter's dense W_eff lives
        for one forward."""
        base = self._compute_copy()
        if params is None:
            return base
        cdt = self.dtype_policy.compute_dtype
        out = {}
        for v, p in params.items():
            own = self.params_tree.get(v, {})
            shared = all(p.get(k) is t for k, t in own.items())
            if shared and len(p) == len(own):
                out[v] = base[v]
                continue
            plain = shared and not any(map(lora_mod.is_lora_leaf, own))
            out[v] = params_mod.prep_layer_params(
                p, cdt, self._layer_confs.get(v),
                cast=base.get(v) if plain else None)
        return out

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

    def _check_trainable(self) -> None:
        """Raise ValueError for a post-training int8 leaf that `fit` would
        train (frozen, under LoRA, it rides along as data)."""
        spec = self._frozen_spec
        if self.params_tree is not None and any(
                k not in spec.get(v, ()) for v, k in
                params_mod.quantized_leaves(self.params_tree)):
            raise ValueError(
                "fit: these params are post-training-quantized int8 "
                "(checkpoint/quantize.py), a serving artifact; train the "
                "float checkpoint they came from, or freeze the int8 base "
                "and train LoRA adapters over it (nn/transfer.py)")

    def _check_sgd_only_policy(self, what: str) -> None:
        """The reference's refusal (`multilayer.py:909-915`): masters and
        loss scaling belong to the SGD train step."""
        pol = self.dtype_policy
        if pol.low_precision_params or pol.loss_scaling:
            raise ValueError(
                f"{what} does not support dtype policy {pol.name!r}: "
                "low-precision param storage (f32 master copies) and "
                "dynamic loss scaling are SGD-train-step features; use a "
                "float32 / float64 / mixed_bfloat16 policy here")

    def _next_rng(self) -> np.ndarray:
        """Advance the train key, `key, sub = split(key)`; the subkey seeds
        one train-mode forward's draws."""
        self._train_rng, sub = split(self._train_rng)
        ctx = self._step_ctx
        return sub if ctx is None else ctx.step_key(sub)

    def _train_backward(self, loss):
        """`{key: {name: grad}}` of every leaf that requires grad (zeros
        for a leaf the loss does not reach, as jax.grad gives), each
        contiguous as the update kernel takes it: a convolution's kernel
        gradient comes back through the HWIO permute in whatever layout
        cuDNN or the CPU wrote it, and is copied only then; and, under
        loss scaling, a device bool "every gradient is finite" (None
        otherwise). Under loss scaling the backward runs on `loss * scale`
        and the gradients come back as `astype(f32) / scale`; under
        low-precision params they come back as f32. Returns `(grads,
        finite)`."""
        pol = self.dtype_policy
        names = [(v, k) for v, p in self.params_tree.items()
                 for k, t in p.items() if t.requires_grad]
        leaves = [self.params_tree[v][k] for v, k in names]
        scale = self.opt_state["_ls"][0] if pol.loss_scaling else None
        finite = None
        if scale is not None:
            loss = loss * scale.to(loss.dtype)
        with torch.inference_mode(False):
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        flat = [torch.zeros_like(leaf) if gr is None else gr.contiguous()
                for leaf, gr in zip(leaves, flat)]
        if scale is not None:
            flat = [gr.to(torch.float32) / scale for gr in flat]
            finite = torch.stack(
                [torch.isfinite(gr).all() for gr in flat]).all()
        elif pol.low_precision_params:
            flat = [gr.to(torch.float32) for gr in flat]
        grads: Dict[str, Dict[str, torch.Tensor]] = {}
        for (v, k), gr in zip(names, flat):
            grads.setdefault(v, {})[k] = gr
        return grads, finite

    def _train_update(self, grads, finite) -> None:
        with torch.no_grad():
            self._apply_updates(grads, finite)
            if finite is not None:
                self._update_loss_scale(finite)
        self._compute_params = None  # the inference copy is stale now

    def _update_loss_scale(self, fin) -> None:
        """The scale's backoff and growth after a step whose gradients were
        all finite or not (`fin`, a device bool), as device ops, in place
        (reference graph.py:719-727)."""
        pol = self.dtype_policy
        scale, good = self.opt_state["_ls"]
        new_good = torch.where(fin, good + 1.0, torch.zeros_like(good))
        grow = new_good >= float(pol.growth_interval)
        new_scale = torch.where(
            fin, torch.where(grow, scale * pol.growth_factor, scale),
            scale * pol.backoff_factor)
        good.copy_(torch.where(grow, torch.zeros_like(good), new_good))
        scale.copy_(new_scale)

    def _keep_state(self, new_state, fin, detach: bool = False) -> None:
        """Merge a step's new layer state into `self.state`; under loss
        scaling (`fin` the step's finite bool, None without) an entry the
        state already had keeps its old value when the step is skipped
        (reference graph.py:709-714)."""
        for n, s in new_state.items():
            old = self.state.get(n, {})
            upd = {}
            for k, v in s.items():
                if detach:
                    v = v.detach()
                if fin is not None and k in old:
                    v = torch.where(fin, v, old[k])
                upd[k] = v
            self.state[n] = {**old, **upd}

    def _apply_updates(self, grads, fin) -> None:
        """Per layer (reference `_train_step`): normalize, schedule, update,
        bias-rate factor, then params -= sign * deltas, in place. Layers
        whose updater has a fused body (Adam, Nesterovs, RMSProp) are
        gathered by (kind, hyper) and updated together by one
        `fused_update.apply_step` each (on the card one kernel launch over
        all their tensors, which writes the params too); the others take
        their updater's deltas here. Under loss scaling (`fin` the step's
        finite bool, None without) a skipped step writes nothing: a device
        select here, the fused update's skip flag there. The step is
        `self.iteration`, which a truncated-BPTT sequence advances once,
        after its last chunk."""
        g = self._global
        sign = 1.0 if g.minimize else -1.0
        step = self.iteration
        lowp = self.dtype_policy.low_precision_params
        # Under low-precision params the update runs on the f32 masters,
        # and the stored params take their cast.
        base = self.opt_state["_master"] if lowp else self.params_tree
        skip = None if fin is None else (~fin).to(torch.int32)
        collect = self._collect_stats
        stats: Dict[str, Dict] = {}
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
            if updater.fused is not None and not collect:
                groups.setdefault(updater.fused, []).append(
                    (name, fused_update.UpdateItem(
                        base[name], self.opt_state[name], lgrads, lr,
                        factors, self.params_tree[name] if lowp else None,
                        self._schedules[name])))
                continue
            old = self.opt_state[name]
            if updater.fused is not None and fin is not None:
                # The seam updates the state in place on the card; a
                # skipped step selects these copies back.
                old = {f: {k: t.clone() for k, t in fs.items()}
                       for f, fs in old.items()}
            st, deltas = updater.update(self.opt_state[name], lgrads, lr,
                                        step)
            params = base[name]
            before = ({k: p.clone() for k, p in params.items()}
                      if fin is not None else None)
            if collect:
                deltas = {k: d * factors[k] if factors and k in factors
                          else d for k, d in deltas.items()}
                factors = None
            fused_update.apply_deltas(params, deltas, factors, sign)
            if fin is not None:
                for k, p in params.items():
                    p.copy_(torch.where(fin, p, before[k]))
                st = {f: {k: torch.where(fin, t, old[f][k])
                          for k, t in fs.items()} for f, fs in st.items()}
            if lowp:
                for k in deltas:  # frozen leaves keep their stored bits
                    self.params_tree[name][k].copy_(params[k])
            self.opt_state[name] = st
            if collect:
                stats[name] = {k: {"grad_mm": g_.abs().mean(),
                                   "update_mm": deltas[k].abs().mean(),
                                   "param_mm": params[k].abs().mean()}
                               for k, g_ in lgrads.items()}
        if collect:
            self.last_training_stats = stats
        extra = {} if skip is None else {"skip": skip}
        if self._step_ctx is not None:
            extra["slots"] = self._step_ctx.slots
        for (kind, hyper), members in groups.items():
            states = fused_update.apply_step(
                kind, hyper, [item for _, item in members], step, sign,
                self._update_tables, **extra)
            for (name, _), st in zip(members, states):
                self.opt_state[name] = st

    # ---------------------------------------------------- solver, superstep

    def _objective(self, params, item):
        """The deterministic loss of `item` at `params` (a `{key: {name:
        tensor}}` tree at the param dtype): no dropout, BatchNorm's running
        statistics, the state as it is (reference `solver_step`,
        `gradientcheck._score_fn_*`). Differentiable in `params`."""
        raise NotImplementedError

    def _sgd_step(self, item) -> None:
        """One SGD train step on one batch (no iteration, no listener)."""
        raise NotImplementedError

    def _flat_keys(self):
        """The params' `(key, name)` in the reference's flat order
        (`ravel_pytree`, `tree_flatten`: keys sorted at each level)."""
        return [(v, k) for v in sorted(self.params_tree)
                for k in sorted(self.params_tree[v])]

    def _fit_solver(self, item, algo) -> None:
        """Minimize one batch's objective over the flat params for
        `iterations` solver iterations (see the module docstring)."""
        self._check_sgd_only_policy(
            "solver optimizers (LBFGS/CG/line search)")
        g = self._global
        keys = self._flat_keys()
        leaves = [self.params_tree[v][k] for v, k in keys]
        sizes = [t.numel() for t in leaves]
        w0 = torch.cat([t.detach().reshape(-1) for t in leaves])

        def unflat(w):
            tree: Dict[str, Dict[str, torch.Tensor]] = {}
            for (v, k), t, part in zip(keys, leaves, torch.split(w, sizes)):
                tree.setdefault(v, {})[k] = part.reshape(t.shape)
            return tree

        iters = max(1, int(g.iterations))
        w, loss = solvers_mod.minimize(
            algo, lambda w: self._objective(unflat(w), item), w0,
            iterations=iters,
            max_line_search=max(1, int(g.max_num_line_search_iterations)))
        with torch.no_grad():
            for t, part in zip(leaves, torch.split(w, sizes)):
                t.copy_(part.reshape(t.shape))
        self._compute_params = None
        self._score = loss
        self.iteration += iters
        # The stats are the SGD step's; a solver leaves none (reference
        # multilayer.py:989).
        self.last_training_stats = {}
        for listener in self.listeners:
            listener.iteration_done(self, self.iteration)

    def _solver_algo(self):
        """The conf's solver, or None for SGD."""
        algo = OptimizationAlgorithm.of(self._global.optimization_algo)
        return (None if algo == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
                else algo)

    def _tbptt(self) -> bool:
        return str(self.conf.backprop_type).lower() == "truncatedbptt"

    # -------------------------------------------------------- observability

    def _fit_items(self, src) -> None:
        """Dispatch every item of `src` (an epoch's source, perhaps a
        stager), each iterator-next timed apart: with staged input that
        wait is the device starving. An abandoned epoch leaves nothing
        staged."""
        src_it = iter(src)
        try:
            while True:
                t_wait = time.perf_counter()
                try:
                    item = next(src_it)
                except StopIteration:
                    break
                self._last_input_wait = time.perf_counter() - t_wait
                self._metrics.input_wait.observe(self._last_input_wait)
                self._fit_dispatch(item)
        finally:
            staging.close_stager(src_it)
            staging.close_stager(src)

    def _observed_dispatch(self, item, run) -> None:
        """`run(item)` (the dispatch of one prepared batch) inside the
        observability of the module docstring."""
        m = self._metrics
        h2d = batch_host_nbytes(item, self.device)
        m.h2d.inc(h2d)
        k = int(getattr(item, "k", 1))
        it0 = self.iteration
        self._superstep_losses = None
        t0 = time.perf_counter()
        with _obs.iteration_span(m.engine, it0 + 1):
            try:
                with self._program_memory(item):
                    run(item)
            except Exception as e:
                # The bundle is written before the exception unwinds fit.
                _obs.flight.on_crash(f"{m.engine}.dispatch", e)
                raise
            finally:
                dt = time.perf_counter() - t0
                m.dispatch_observe(k, dt)
                m.iters.inc(max(0, self.iteration - it0))
                _obs.flight.record_step(
                    m.engine, self.iteration, loss=self._score, seconds=dt,
                    k=k, h2d_bytes=h2d, input_wait=self._last_input_wait,
                    jit_hits=m.jit_hit.get(), jit_misses=m.jit_miss.get(),
                    losses=self._superstep_losses)

    def _program_memory(self, item):
        """On the card, the first dispatch of a batch signature records
        its device memory as `<engine>.train_step`; otherwise nothing."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        sig = dispatch_signature(item)
        if sig in self._programs_seen:
            return contextlib.nullcontext()
        self._programs_seen.add(sig)
        return _mem.program_memory(f"{self._metrics.engine}.train_step",
                                   net=self)

    def _superstep_k(self) -> int:
        """K for this engine: `DL4J_TPU_SUPERSTEP_K`, else the conf's
        `superstep_k`; 0 (per batch) under a stats listener, `iterations
        > 1`, truncated BPTT or a solver (reference multilayer.py:886)."""
        env = os.environ.get("DL4J_TPU_SUPERSTEP_K")
        g = self._global
        try:
            k = int(env) if env else int(getattr(g, "superstep_k", 0) or 0)
        except ValueError:
            return 0
        if (k < 2 or self._collect_stats or max(1, int(g.iterations)) != 1
                or self._tbptt() or self._solver_algo() is not None):
            return 0
        return k

    def _superstep_wrap(self, iterator, k: int, transform=None):
        """`iterator` as a `SuperbatchIterator` of K-blocks, the wrapper
        cached on the base iterator so a device-cached epoch stacks once
        (reference multilayer.py:918-938)."""
        sbi = iterators_mod.SuperbatchIterator
        tdt = self.dtype_policy.transfer_dtype
        if isinstance(iterator, sbi):
            return iterator
        wrapper = getattr(iterator, "_superbatch_wrapper", None)
        if (isinstance(wrapper, sbi) and wrapper.base is iterator
                and wrapper.k == k and wrapper.transfer_dtype == tdt):
            wrapper.net = self
            return wrapper
        wrapper = sbi(iterator, k, transform=transform, transfer_dtype=tdt,
                      net=self)
        try:
            iterator._superbatch_wrapper = wrapper
        except (AttributeError, TypeError):
            pass  # a list or a tuple: wrapped again at each fit
        return wrapper

    def _fit_superstep(self, sb) -> None:
        """K train steps over a stacked block (see the module docstring),
        then the K scores to the listeners, one iteration each (reference
        multilayer.py:940-967)."""
        k = int(sb.k)
        base = self.iteration
        losses = None
        if self.device.type == "cuda" and k > 1:
            losses = superstep_mod.run(
                self, sb, hit=self._metrics.jit_hit,
                miss=self._metrics.jit_miss)
        if losses is None:
            losses = []
            for j in range(k):
                self.iteration = base + j
                self._sgd_step(sb.batch(j))
                losses.append(self._score)
            self.iteration = base
        self._superstep_losses = losses
        for loss in losses:
            self._score = loss
            self.iteration += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.iteration)

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
        master = self.opt_state.get("_master") if self.opt_state else None
        with torch.no_grad():
            for lk, p in new.items():
                for k, a in p.items():
                    self.params_tree[lk][k].copy_(a)
                    if master is not None:
                        # The masters follow a view set from outside
                        # (reference multilayer.py:1300-1304).
                        master[lk][k].copy_(self.params_tree[lk][k])
        self._compute_params = None

    def _updater_leaves(self) -> List[torch.Tensor]:
        """The updater state's tensors in the reference's leaf order."""
        def walk(tree):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    yield from walk(tree[k])
            elif isinstance(tree, (tuple, list)):
                for t in tree:
                    yield from walk(t)
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
