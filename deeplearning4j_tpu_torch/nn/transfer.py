"""Transfer learning: frozen layers and the LoRA wiring (counterpart of
`deeplearning4j_tpu/nn/transfer.py`, the reference's
`TransferLearning.Builder` and `FrozenLayer`).

A frozen layer is no wrapper but a spec: `frozen_spec` computes, from the
layer confs (`frozen`, `lora_rank`), the param leaves that do not train.
Both engines read it the same way (`nn/engine.py`):

- the updater state is built over the trainable subtree only, so a frozen
  leaf has no Adam or RMSProp moments (a fully frozen layer's entry is
  `()`): fine-tuning's state scales with what trains;
- frozen leaves are stored with `requires_grad=False`, so the backward
  asks for no gradient of them and the fused update (row 9) never sees
  them. That is also what lets LoRA train over an int8 base: the
  quantized leaves ride along as data;
- under low-precision params the f32 masters of frozen leaves stay beside
  the trained ones, unchanged.

The spec is empty for an ordinary net, and `split_tree` / `merge_tree`
are the identity then. `TransferLearning(net)` freezes a prefix or named
layers, attaches LoRA adapters (`nn/lora.py`) and `build()`s a new
engine.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import lora as lora_mod

FrozenSpec = Dict[str, FrozenSet[str]]


def frozen_spec(layer_items, params_tree) -> FrozenSpec:
    """`{layer_key: frozenset(names that do not train)}` from the layer
    confs; only layers with `frozen=True` or `lora_rank` contribute, so an
    unconfigured net gives `{}`. In a contributing layer every base leaf
    freezes (biases, int8 `__scale` companions and the constant
    `__lora_scale` too); the `__lora_a` / `__lora_b` pair trains unless
    the layer is also `frozen`."""
    spec: FrozenSpec = {}
    for lk, conf in layer_items:
        lparams = (params_tree or {}).get(lk)
        if not lparams:
            continue
        layer_frozen = bool(getattr(conf, "frozen", None))
        has_lora = bool(getattr(conf, "lora_rank", None) or 0)
        if not layer_frozen and not has_lora:
            continue
        names = {name for name in lparams
                 if layer_frozen
                 or not name.endswith((lora_mod.LORA_A, lora_mod.LORA_B))}
        if names:
            spec[lk] = frozenset(names)
    return spec


def split_tree(tree, spec: FrozenSpec):
    """The (trainable, frozen) halves of a params tree. Both keep every
    layer key (an empty dict where a side has nothing); tensors are never
    copied."""
    trainable: Dict[str, Any] = {}
    frozen: Dict[str, Any] = {}
    for lk, lparams in tree.items():
        names = spec.get(lk)
        if not names:
            trainable[lk] = lparams
            frozen[lk] = {}
            continue
        trainable[lk] = {k: a for k, a in lparams.items() if k not in names}
        frozen[lk] = {k: a for k, a in lparams.items() if k in names}
    return trainable, frozen


def merge_tree(trainable, frozen):
    """The inverse of `split_tree`: the full tree, frozen leaves put back
    as the same tensors."""
    out: Dict[str, Any] = {}
    for lk, lparams in trainable.items():
        fro = (frozen or {}).get(lk) or {}
        if fro:
            merged = dict(lparams)
            merged.update(fro)
            out[lk] = merged
        else:
            out[lk] = lparams
    return out


def _layer_items(net) -> List[Tuple[str, Any]]:
    """(layer key, layer conf) of either engine in its canonical order:
    MultiLayerNetwork's layer order, a graph's layer vertices in
    topological order."""
    if hasattr(net, "layer_vertices"):
        order = [n for n in net.conf.topological_order()
                 if n in net.layer_vertices]
        return [(n, net.layer_vertices[n].layer) for n in order]
    return list(zip(net.layer_keys, net.layers))


class TransferLearning:
    """Builder of a fine-tuning copy of an initialized engine (reference
    `TransferLearning`).

    >>> tuned = (TransferLearning(base)
    ...          .freeze_up_to("layer_2")      # feature extractor
    ...          .add_lora(rank=8, alpha=16)   # adapters on eligible layers
    ...          .build())

    `build()` returns a new engine of the same class on the source net's
    device: a deep copy of its conf with `frozen`, `lora_rank` and
    `lora_alpha` stamped on the layer confs (so checkpoints and clones
    carry the setup), copies of its base params, fresh LoRA leaves where
    asked, and its layer state carried over. The source net is never
    changed."""

    def __init__(self, net):
        if getattr(net, "params_tree", None) is None:
            raise ValueError(
                "TransferLearning needs an initialized net (call init())")
        self._net = net
        self._items = _layer_items(net)
        self._keys = [k for k, _ in self._items]
        self._freeze: set = set()
        self._lora: Dict[str, Tuple[int, Optional[float]]] = {}

    def _resolve(self, ident) -> str:
        if isinstance(ident, int):
            if not 0 <= ident < len(self._keys):
                raise ValueError(f"layer index {ident} out of range "
                                 f"0..{len(self._keys) - 1}")
            return self._keys[ident]
        key = str(ident)
        if key not in self._keys:
            raise ValueError(
                f"unknown layer {ident!r}; layers: {self._keys}")
        return key

    # ------------------------------------------------------------ freezing

    def freeze_up_to(self, ident) -> "TransferLearning":
        """Freeze every layer up to and including `ident` (the reference's
        `setFeatureExtractor`)."""
        key = self._resolve(ident)
        self._freeze.update(self._keys[: self._keys.index(key) + 1])
        return self

    def freeze(self, *idents) -> "TransferLearning":
        """Freeze layers by index or by key (a vertex name)."""
        self._freeze.update(self._resolve(i) for i in idents)
        return self

    # ---------------------------------------------------------------- lora

    def add_lora(self, rank: int, alpha: Optional[float] = None,
                 layers=None) -> "TransferLearning":
        """Attach rank-`rank` adapters (`nn/lora.py`): `layers=None` takes
        every eligible layer (one with a 2-D weight), and naming a layer
        that is not eligible raises. A LoRA layer's base params freeze;
        only its factors train."""
        rank = int(rank)
        if rank <= 0:
            raise ValueError(f"lora rank must be positive, got {rank}")
        if layers is None:
            chosen = [k for k, conf in self._items
                      if lora_mod.lora_target_names(conf)]
            if not chosen:
                raise ValueError("no LoRA-eligible layer (2-D weights) found")
        else:
            chosen = []
            for ident in layers:
                key = self._resolve(ident)
                conf = dict(self._items)[key]
                if not lora_mod.lora_target_names(conf):
                    raise ValueError(
                        f"layer {key!r} ({type(conf).__name__}) has no 2-D "
                        f"weight to adapt")
                chosen.append(key)
        for key in chosen:
            self._lora[key] = (rank, alpha)
        return self

    # --------------------------------------------------------------- build

    def _conf_items(self, conf) -> Dict[str, Any]:
        if hasattr(conf, "vertices"):
            return {name: conf.vertices[name].layer for name in self._keys}
        return {self._keys[i]: conf.layers[i] for i in range(len(self._keys))}

    def build(self):
        src = self._net
        conf = copy.deepcopy(src.conf)
        citems = self._conf_items(conf)
        for key in self._freeze:
            citems[key].frozen = True
        for key, (rank, alpha) in self._lora.items():
            citems[key].lora_rank = rank
            if alpha is not None:
                citems[key].lora_alpha = float(alpha)
        new_net = type(src)(conf, device=src.device)
        pol = new_net.dtype_policy
        pdt = (torch.float32 if pol.low_precision_params
               else pol.param_dtype)
        gen = torch.Generator().manual_seed(int(conf.global_conf.seed) ^ 0x10A)
        # `init` copies every tensor it is given: the base leaves as the
        # source stores them (under low-precision params the masters are
        # their f32 cast, as in the reference), then the fresh factors.
        params: Dict[str, Dict[str, torch.Tensor]] = {
            lk: dict(lp) for lk, lp in src.params_tree.items()}
        for key in self._keys:
            if key in self._lora:
                params.setdefault(key, {}).update(lora_mod.init_lora_params(
                    citems[key], gen, dtype=pdt))
        new_net.init(params=params)
        # Carry the layer state (BatchNorm running statistics, center-loss
        # centers) over.
        with torch.no_grad():
            for lk, s in (src.state or {}).items():
                if lk in new_net.state:
                    for k, t in s.items():
                        if k in new_net.state[lk]:
                            new_net.state[lk][k].copy_(t)
        return new_net
