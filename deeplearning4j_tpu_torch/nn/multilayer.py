"""MultiLayerNetwork (counterpart of `deeplearning4j_tpu/nn/multilayer.py`):
the sequential engine, layers `layer_0 ... layer_{n-1}` run in order,
eagerly, each after its input preprocessor if the conf has one, with the
engines' shared params, updaters and in-place update (`engine.py`).

- `fit` takes a DataSet, `features, labels`, or an iterable of DataSets (a
  `DataSetIterator` is reset first), one pass. Listeners
  (`set_listeners`) get `on_epoch_start`, then `iteration_done(net,
  iteration)` after every iteration (a step, or a whole truncated-BPTT
  sequence), then `on_epoch_end` (reference `:797-831, 1093`).
- `fit` takes one optimizer step per batch, or, for a truncated-BPTT conf
  and a sequence longer than `tbptt_fwd_length`, one per chunk of that
  many steps (reference `doTruncatedBPTT`, `multilayer.py:1096`): each chunk
  is a whole forward, backward and update; the recurrent layers' h and c
  carry into the next chunk detached, so the gradient stops at the chunk's
  edge; every chunk of a sequence uses one step value and the iteration
  advances once per sequence; the loss of every chunk divides by the rows
  of the whole sequence; a shorter last chunk runs at its own length; the
  score is the last chunk's; the carried state is dropped afterwards.
- `rnn_time_step` keeps each recurrent layer's h and c across calls until
  `rnn_clear_previous_state` (reference `rnnTimeStep`, :1232).
- `params()` / `set_params()` are the reference's flat view: layer order,
  then each layer's `param_shapes()` order.
- `evaluate` runs `output` over an iterator into an `Evaluation`;
  `updater_state_flat()` / `set_updater_state_flat()` are the flat
  updater view in the reference's leaf order (its `tree_leaves`: every
  dict's keys sorted, at every level), which the model zip stores.

- Dropout and DropConnect draw in `fit` (a new key per step, per tBPTT
  chunk) and in `output` / `feed_forward` with `train=True` (a new key
  per call), as the reference's do (`engine.py`, `nn/layers/common.py`);
  inference draws nothing. A features mask reaches every layer, and global
  pooling consumes it (`nn/layers/__init__.py` `mask_after`).
- The loss adds a `CenterLossOutputLayer`'s center term, and the MoE
  layers' load-balance terms undivided by the batch (`engine.py`
  `take_aux_loss`, `center_loss`); a training step also moves the
  layer's class centers.
- `pretrain(iterator, epochs)` is layerwise pretraining (reference `:999-
  1062`): for each pretrainable layer in order (AutoEncoder, RBM, VAE:
  `PRETRAIN_LOSSES`), `epochs` passes over the data, one step a batch:
  the stack below it run in inference mode and its input preprocessor,
  then the layer's own objective from a new subkey of the train key
  (`_next_rng`, so the key and the iteration carry on into `fit`), its
  gradient, and its own updater and learning-rate schedule at the
  iteration's step, with no l1/l2, no gradient normalization and no
  bias-rate factor (the fused updaters in one `apply_step`, row 9 on the
  card). Listeners get `iteration_done` after every step. `fit` runs it
  first when the conf says `pretrain`, and its backprop pass only when
  the conf says `backprop`. (The reference also refuses pretraining under
  low-precision params or loss scaling; the port refuses those policies
  when the network is built, ROADMAP A.7.)

What `fit` does not run yet raises NotImplementedError naming its ROADMAP
item: solvers and superstep (A.10), frozen layers (A.12) and f16 loss
scaling (A.7).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import maybe_reset
from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.kernels import fused_update
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn import losses as losses_mod
from deeplearning4j_tpu_torch.nn import params as params_mod
from deeplearning4j_tpu_torch.nn import rnn_state as rnn_mod
from deeplearning4j_tpu_torch.nn.conf import preprocessors as pre_mod
from deeplearning4j_tpu_torch.nn.conf.neural_net import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.engine import (
    NetworkEngine,
    center_loss,
    take_aux_loss,
    to_numpy,
)
from deeplearning4j_tpu_torch.nn.layers import (
    OUTPUT_LAYER_TYPES,
    PRETRAIN_LOSSES,
    get_impl,
    mask_after,
)
from deeplearning4j_tpu_torch.nn.prng import LayerKey


def _as_dataset(data, labels=None) -> DataSet:
    if isinstance(data, DataSet):
        return data
    if labels is None and isinstance(data, tuple) and len(data) == 2:
        data, labels = data  # score((x, y)) / fit((x, y))
    return DataSet(data, labels)


class MultiLayerNetwork(NetworkEngine):
    """Sequential network engine (see module docstring)."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        self.conf = conf
        self.layers = conf.layers
        self.layer_keys = [f"layer_{i}" for i in range(len(conf.layers))]
        super().__init__(conf.global_conf,
                         dict(zip(self.layer_keys, self.layers)), device)
        self._uint8_policy = pre_mod.resolve_uint8_policy(self.layers[:1])

    def init(self, params=None, state=None,
             updater_state=None) -> "MultiLayerNetwork":
        """Params, declared state and updater state, fresh (drawn layer by
        layer in order) or given: see `NetworkEngine._init_engine`."""
        self._init_engine(params, updater_state, state, self.layer_keys)
        return self

    # --------------------------------------------------------------- forward

    def _forward(self, params, state, x, fmask, keep_rnn_state: bool,
                 train: bool = False, collect: bool = False, key=None,
                 upto=None, aux=None):
        """Run the layers (the first `upto` of them if given); returns
        (the last layer's raw output at the compute dtype, new layer
        state, every layer's output when `collect`). Declared state comes
        back always, the recurrent layers' h and c only with
        `keep_rnn_state`. `key` (a train forward's subkey) gives layer i
        its draws' `LayerKey(key, i)`. A dict as `aux` collects what the
        loss needs beside the output: the MoE layers' `aux_loss`, a
        center-loss layer's input and centers."""
        x = pre_mod.apply_uint8_policy(
            torch.as_tensor(x, device=self.device), self._uint8_policy,
            self.dtype_policy.compute_dtype)
        mask = (None if fmask is None
                else torch.as_tensor(fmask, device=self.device))
        new_state, acts = {}, []
        pre = self.conf.input_preprocessors
        n = len(self.layers) if upto is None else upto
        for i, (lk, layer) in enumerate(zip(self.layer_keys[:n],
                                            self.layers[:n])):
            if i in pre:
                x, mask = pre[i](x, mask)
            if aux is not None and type(layer).__name__ == \
                    "CenterLossOutputLayer":
                aux["center_loss_input"] = x
                aux["centers"] = state.get(lk, {}).get("centers")
            x, lstate = get_impl(layer)(
                layer, params.get(lk, {}), state.get(lk, {}), x, train=train,
                mask=mask, rng=None if key is None else LayerKey(key, i))
            lstate = take_aux_loss(lstate, aux)
            mask = mask_after(layer, mask)
            if lstate:
                declared = set(layer.state_shapes())
                keep = {k: v for k, v in lstate.items()
                        if k in declared or keep_rnn_state}
                if keep:
                    new_state[lk] = keep
            if collect:
                acts.append(x)
        return x, new_state, acts

    def _finish(self, preout):
        """The output at the output dtype, after the output layer's
        activation."""
        out = preout.to(self.dtype_policy.output_dtype)
        last = self.layers[-1]
        if type(last).__name__ in OUTPUT_LAYER_TYPES:
            out = activations.resolve(last.activation)(out)
        return out

    def output(self, x, train: bool = False,
               features_mask=None) -> np.ndarray:
        """Forward (reference `output`, :1193); `train=True` runs the
        layers in training mode, dropout drawn from a new key."""
        key = self._next_rng() if train else None
        with torch.inference_mode():
            out, _, _ = self._forward(self._compute_copy(), self.state, x,
                                      features_mask, keep_rnn_state=False,
                                      train=train, key=key)
            return to_numpy(self._finish(out))

    def feed_forward(self, x, train: bool = False,
                     features_mask=None) -> List[np.ndarray]:
        """Every layer's output (reference `feedForward`); an output
        layer's entry is its pre-activation."""
        key = self._next_rng() if train else None
        with torch.inference_mode():
            _, _, acts = self._forward(self._compute_copy(), self.state, x,
                                       features_mask, keep_rnn_state=False,
                                       train=train, collect=True, key=key)
            return [to_numpy(a) for a in acts]

    def predict(self, x) -> np.ndarray:
        return np.argmax(self.output(x), axis=-1)

    # ------------------------------------------------------------------ loss

    def _loss(self, params, preout, labels, lmask, aux, eb=None):
        """The output layer's loss in the loss dtype, summed over entries
        and divided by `eb` (default: the minibatch rows), a center-loss
        layer's center term over the same divisor, the MoE layers'
        `aux_loss` undivided, plus the l1/l2 penalty over `eb` (reference
        `_loss_from_preout`); and the state the step moves (the centers)."""
        layer = self.layers[-1]
        if type(layer).__name__ not in OUTPUT_LAYER_TYPES:
            raise ValueError(f"the last layer ({type(layer).__name__}) is "
                             "not an output layer; it has no loss")
        if eb is None:
            eb = losses_mod.effective_batch_size(labels, lmask)
        data_loss = losses_mod.score(
            layer.loss_function, labels, preout.to(self._loss_dtype),
            layer.activation, lmask, eb=eb)
        extra = {}
        if type(layer).__name__ == "CenterLossOutputLayer":
            term, centers = center_loss(
                layer, aux["center_loss_input"], aux["centers"], labels,
                lmask, eb, self._loss_dtype)
            data_loss = data_loss + term
            extra[self.layer_keys[-1]] = {"centers": centers}
        if "aux_loss" in aux:
            data_loss = data_loss + aux["aux_loss"]
        return data_loss + self._l1_l2_penalty(params) / eb, extra

    def _batch(self, ds: DataSet):
        """Features, labels and masks of one DataSet, on the device."""
        return tuple(None if a is None else torch.as_tensor(
            a, device=self.device) for a in (ds.features, ds.labels,
                                             ds.features_mask,
                                             ds.labels_mask))

    def score(self, data, labels=None) -> float:
        """Loss of the current params on one batch (syncs)."""
        x, y, fmask, lmask = self._batch(_as_dataset(data, labels))
        aux = {}
        with torch.inference_mode():
            preout, _, _ = self._forward(self._compute_copy(), self.state, x,
                                         fmask, keep_rnn_state=False,
                                         aux=aux)
            return float(self._loss(self.params_tree, preout, y, lmask,
                                    aux)[0])

    # ------------------------------------------------------------------- fit

    def fit(self, data, labels=None) -> "MultiLayerNetwork":
        """Train on a DataSet, an iterable of DataSets, or `features,
        labels`: one pass (reference `fit`, :775)."""
        if self.params_tree is None:
            self.init()
        self._check_trainable()
        if labels is not None or isinstance(data, DataSet) or (
                isinstance(data, tuple) and len(data) == 2
                and not isinstance(data[0], DataSet)):
            items = [_as_dataset(data, labels)]
        else:
            items = data
        maybe_reset(items)
        if self.conf.pretrain:
            if not hasattr(items, "reset") and not isinstance(
                    items, (list, tuple)):
                items = list(items)  # both passes read a one-shot iterable
            self.pretrain(items)
            maybe_reset(items)
        for listener in self.listeners:
            listener.on_epoch_start(self)
        if self.conf.backprop:
            for ds in items:
                self._fit_dispatch(_as_dataset(ds))
        self.epoch += 1
        for listener in self.listeners:
            listener.on_epoch_end(self)
        return self

    def _fit_dispatch(self, ds: DataSet) -> None:
        """Truncated BPTT for a sequence longer than a chunk, else one step
        (reference `_fit_dispatch_inner`, :868)."""
        tbptt = str(self.conf.backprop_type).lower() == "truncatedbptt"
        for _ in range(max(1, int(self.conf.global_conf.iterations))):
            if (tbptt and ds.features.ndim == 3
                    and ds.features.shape[1] > self.conf.tbptt_fwd_length):
                self._fit_tbptt(ds)
            else:
                x, y, fmask, lmask = self._batch(ds)
                self._train_step(x, y, fmask, lmask, carry_rnn=False)
                self._iteration_done()

    def _train_step(self, x, y, fmask, lmask, carry_rnn: bool,
                    eb=None) -> None:
        """One step in three parts (each a method, so a profiler can wrap
        them on the instance): forward + loss, backward, update. The new
        layer state (running statistics; with `carry_rnn` the recurrent h
        and c) is kept detached: a chunk's gradient ends at its edge."""
        loss, new_state = self._train_forward(x, y, fmask, lmask, carry_rnn,
                                              eb)
        grads = self._train_backward(loss)
        self._train_update(grads)
        for lk, s in new_state.items():
            self.state[lk] = {**self.state.get(lk, {}),
                              **{k: v.detach() for k, v in s.items()}}
        self._score = loss.detach()

    def _train_forward(self, x, y, fmask, lmask, carry_rnn, eb):
        """The loss, recorded by autograd from the f32 leaves through their
        compute-dtype cast, and the new layer state."""
        with torch.inference_mode(False), torch.enable_grad():
            params = params_mod.cast_floating(self.params_tree,
                                              self.dtype_policy.compute_dtype)
            aux = {}
            preout, new_state, _ = self._forward(
                params, self.state, x, fmask, keep_rnn_state=carry_rnn,
                train=True, key=self._next_rng(), aux=aux)
            loss, extra = self._loss(self.params_tree, preout, y, lmask, aux,
                                     eb)
        for lk, s in extra.items():
            new_state.setdefault(lk, {}).update(s)
        return loss, new_state

    def _fit_tbptt(self, ds: DataSet) -> None:
        """Truncated BPTT over one batch of sequences (see the module
        docstring; reference `_fit_tbptt`, :1096)."""
        if rnn_mod.decode_capacity(self.layers) is not None:
            raise ValueError(
                "truncated BPTT carries undeclared layer state across "
                "chunks, which would thread attention KV caches into "
                "training; unset decode_cache_length (it is an inference "
                "feature) or use standard backprop")
        x, y, fmask, lmask = self._batch(ds)
        if y is None or not (y.dim() == 3 or (
                y.dim() == 2 and not y.is_floating_point())):
            raise ValueError(
                "Truncated BPTT requires per-timestep labels: [b, t, c] "
                "one-hot or [b, t] integer class ids")
        fwd, t = int(self.conf.tbptt_fwd_length), x.shape[1]
        eb = losses_mod.effective_batch_size(x, lmask)
        saved_state = dict(self.state)  # the steps below add h and c
        for start in range(0, t, fwd):
            sl = slice(start, min(start + fwd, t))
            self._train_step(
                x[:, sl], y[:, sl], None if fmask is None else fmask[:, sl],
                None if lmask is None else lmask[:, sl], carry_rnn=True,
                eb=eb)
        # Drop the carried h and c; keep declared state (running stats).
        declared = self._declared_state()
        kept = {lk: {k: v for k, v in s.items() if k in declared.get(lk, ())}
                for lk, s in self.state.items()}
        self.state = {lk: s for lk, s in kept.items() if s}
        for lk, s in saved_state.items():
            self.state.setdefault(lk, s)
        self._iteration_done()

    # ------------------------------------------------------------- pretrain

    def pretrain(self, iterator, epochs: int = 1) -> "MultiLayerNetwork":
        """Layerwise unsupervised pretraining of the AutoEncoder, RBM and
        VAE layers (see the module docstring; reference `pretrain`)."""
        if self.params_tree is None:
            self.init()
        if isinstance(iterator, DataSet):
            iterator = [iterator]
        elif not hasattr(iterator, "reset") and not isinstance(
                iterator, (list, tuple)):
            iterator = list(iterator)  # every layer and epoch reads it
        for i, layer in enumerate(self.layers):
            loss_impl = PRETRAIN_LOSSES.get(type(layer).__name__)
            if loss_impl is None:
                continue
            for _ in range(max(1, epochs)):
                maybe_reset(iterator)
                for ds in iterator:
                    self._pretrain_step(i, layer, loss_impl,
                                        _as_dataset(ds).features)
        return self

    def _pretrain_step(self, i: int, layer, loss_impl, x) -> None:
        """One step of layer i's own objective (reference
        `_pretrain_step`)."""
        lk = self.layer_keys[i]
        params = self.params_tree[lk]
        key = self._next_rng()
        with torch.no_grad():
            h, _, _ = self._forward(self._compute_copy(), self.state, x, None,
                                    keep_rnn_state=False, upto=i)
            prep = self.conf.input_preprocessors.get(i)
            if prep is not None:
                h, _ = prep(h, None)
            # The objective reads the stored params (bf16 activations
            # promote to them, as in the reference).
            h = h.to(self.dtype_policy.param_dtype)
        with torch.inference_mode(False), torch.enable_grad():
            loss = loss_impl(layer, params, h, key)
            names = list(params)
            flat = torch.autograd.grad(loss, [params[k] for k in names],
                                       allow_unused=True)
        grads = {k: (torch.zeros_like(params[k]) if g is None
                     else g.contiguous()) for k, g in zip(names, flat)}
        step = self.iteration
        lr = self._schedules[lk](step)
        updater = self._updaters[lk]
        with torch.no_grad():
            if updater.fused is not None:
                kind, hyper = updater.fused
                self.opt_state[lk], = fused_update.apply_step(
                    kind, hyper, [fused_update.UpdateItem(
                        params, self.opt_state[lk], grads, lr)], step, 1.0)
            else:
                self.opt_state[lk], deltas = updater.update(
                    self.opt_state[lk], grads, lr, step)
                fused_update.apply_deltas(params, deltas, None, 1.0)
        self._compute_params = None  # the inference copy is stale now
        self._score = loss.detach()
        self._iteration_done()

    # ------------------------------------------------------------------ rnn

    def rnn_time_step(self, x) -> np.ndarray:
        """Stateful inference: [b, f] (one step, returned as [b, c]) or
        [b, t, f]; the recurrent layers' h and c persist across calls."""
        x = torch.as_tensor(x)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        self._rnn_pos = rnn_mod.check_decode_budget(
            self._rnn_pos, x.shape[1], rnn_mod.decode_capacity(self.layers))
        state = rnn_mod.merge_rnn_state(self.state, self._rnn_state)
        with torch.inference_mode():
            out, new_state, _ = self._forward(self._compute_copy(), state, x,
                                              None, keep_rnn_state=True)
            self._rnn_state = rnn_mod.split_rnn_state(new_state,
                                                      self._declared_state())
            out = to_numpy(self._finish(out))
        return out[:, 0] if squeeze and out.ndim == 3 else out

    # ------------------------------------------------------------ eval misc

    def evaluate(self, iterator, top_n: int = 1) -> Evaluation:
        """Classification evaluation of `output` over a DataSet or an
        iterable of them (reference `evaluate`, :1259)."""
        ev = Evaluation(top_n=top_n)
        maybe_reset(iterator)
        if isinstance(iterator, DataSet):
            iterator = [iterator]
        for ds in iterator:
            out = self.output(ds.features, features_mask=ds.features_mask)
            ev.eval(ds.labels, out, mask=ds.labels_mask)
        return ev

    # ------------------------------------------------------------- params io

    def _param_layer_order(self):
        return self.layer_keys

    def summary(self) -> str:
        lines = ["=" * 70, f"{'Layer':<28}{'Type':<24}{'Params':>10}",
                 "-" * 70]
        for lk, layer in zip(self.layer_keys, self.layers):
            n = int(sum(np.prod(s) for s in layer.param_shapes().values()))
            lines.append(f"{lk:<28}{type(layer).__name__:<24}{n:>10}")
        lines += ["-" * 70, f"Total params: {self.num_params()}", "=" * 70]
        return "\n".join(lines)
