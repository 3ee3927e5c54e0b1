"""LoRA adapters as sibling low-rank param leaves (counterpart of
`deeplearning4j_tpu/nn/lora.py`; Hu et al., "LoRA").

A layer conf with `lora_rank=r` has, for every 2-D weight `W` among its
`param_shapes()`, three sibling leaves in the same layer dict:

    W__lora_a      [n_in, r]   drawn from N(0, 0.02^2) (trained)
    W__lora_b      [r, n_out]  zeros (trained; the delta starts at 0)
    W__lora_scale  []  f32     alpha / r (a constant, never trained)

The forward reads `W_eff = W + scale * (A @ B)`, formed at the compute
dtype where the params are prepared (`nn/params.py` `prep_layer_params`),
over a base that may be an int8 weight dequantized as `q * scale`.
Freezing the base and leaving the factors to the updater is
`nn/transfer.py`'s.

Because the adapter is ordinary leaves of the params tree, the store,
the flat views and the server see one tree; `extract_adapter` and
`merge_adapter` convert between a full tree and the delta-only tree that
`checkpoint/adapters.py` saves and `serving/host.py` serves per request.
The factors are drawn from an explicit `torch.Generator`: JAX's threefry
stream is not reproduced, so parity tests copy A across.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

LORA_A = "__lora_a"
LORA_B = "__lora_b"
LORA_SCALE = "__lora_scale"
_SUFFIXES = (LORA_A, LORA_B, LORA_SCALE)

# The A factor's init stddev (A ~ N(0, sigma^2), B = 0: the first forward
# is the base's).
_A_INIT_STD = 0.02


def is_lora_leaf(name: str) -> bool:
    return name.endswith(_SUFFIXES)


def lora_target_names(conf) -> List[str]:
    """The weights that take adapters: the layer's declared 2-D weight
    params (Dense, Output and Embedding `W`, attention `Wq`/`Wk`/`Wv`/`Wo`,
    the LSTM's `W`/`RW`, positional tables). HWIO conv kernels and MoE's
    stacked 3-D tables are left out: the factorization is a plain
    matmul."""
    shapes = conf.param_shapes()
    return [k for k in conf.weight_param_keys() if len(shapes[k]) == 2]


def lora_param_shapes(conf) -> Dict[str, Tuple[int, ...]]:
    """The adapter leaves' shapes of a conf (empty without `lora_rank`)."""
    r = int(getattr(conf, "lora_rank", None) or 0)
    if r <= 0:
        return {}
    shapes = conf.param_shapes()
    out: Dict[str, Tuple[int, ...]] = {}
    for name in lora_target_names(conf):
        n_in, n_out = shapes[name]
        out[name + LORA_A] = (n_in, r)
        out[name + LORA_B] = (r, n_out)
        out[name + LORA_SCALE] = ()
    return out


def init_lora_params(conf, generator: torch.Generator,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Fresh adapter leaves of one layer conf (none without `lora_rank`),
    A drawn from `generator` target by target. The scale is its own f32
    0-d leaf, so a saved adapter records alpha / r."""
    r = int(getattr(conf, "lora_rank", None) or 0)
    if r <= 0:
        return {}
    alpha = float(getattr(conf, "lora_alpha", None) or r)
    out: Dict[str, torch.Tensor] = {}
    for name, shape in lora_param_shapes(conf).items():
        if name.endswith(LORA_A):
            out[name] = (torch.randn(shape, generator=generator,
                                     dtype=torch.float32)
                         * _A_INIT_STD).to(dtype)
        elif name.endswith(LORA_B):
            out[name] = torch.zeros(shape, dtype=dtype)
        else:
            out[name] = torch.tensor(alpha / r, dtype=torch.float32)
    return out


def extract_adapter(params_tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The delta-only subtree: every `__lora_*` leaf, keyed as in the full
    tree; layers without one are left out."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for lk, lparams in params_tree.items():
        leaves = {k: a for k, a in lparams.items() if is_lora_leaf(k)}
        if leaves:
            out[lk] = leaves
    return out


def strip_adapter(params_tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The base-only tree: every layer key, every `__lora_*` leaf
    removed."""
    return {lk: {k: a for k, a in lparams.items() if not is_lora_leaf(k)}
            for lk, lparams in params_tree.items()}


def merge_adapter(base_tree, adapter) -> Dict[str, Dict[str, torch.Tensor]]:
    """A full serving tree: the base tree's tensors (shared, never copied)
    overlaid with one adapter's leaves; `adapter=None` gives a shallow
    copy of the base."""
    out = {lk: dict(lparams) for lk, lparams in base_tree.items()}
    for lk, leaves in (adapter or {}).items():
        if lk not in out:
            raise KeyError(f"adapter layer {lk!r} not present in base tree "
                           f"(layers: {sorted(base_tree)})")
        out[lk].update(leaves)
    return out


def adapter_nbytes(adapter) -> int:
    return sum(int(a.numel() * a.element_size())
               for leaves in adapter.values() for a in leaves.values())


def adapter_rank(adapter) -> int:
    """The largest rank among an adapter's factor pairs, read from the
    leaves."""
    r = 0
    for lparams in adapter.values():
        for k, a in lparams.items():
            if k.endswith(LORA_A) and a.dim() == 2:
                r = max(r, int(a.shape[1]))
    return r
