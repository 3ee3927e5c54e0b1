"""What the layers share (counterpart of
`deeplearning4j_tpu/nn/layers/common.py`): inverted dropout on a layer's
input, DropConnect on its input weights, and step masking.

`conf.dropout` is the RETAIN probability (dl4j 0.x's meaning): a unit is
kept with that probability and scaled by 1/retain; None, 0 and 1 disable
it. It is not `F.dropout`'s drop probability. Kept values are `x / retain`
in x's dtype (bf16 under `mixed_bfloat16`, as the reference divides).

Every random draw of the port goes through one of four functions, each
from the key the reference draws at: `draw_keep` (dropout and DropConnect
masks, from the layer's `LayerKey`, `nn/prng.py`), `draw_uniform` (the MoE
router's jitter), `draw_normal` (the VAE's epsilon, `fold_in(key, s)`) and
`draw_bernoulli` (the RBM's Gibbs samples, `fold_in(key, 2k)` and
`fold_in(key, 2k + 1)`, and the AutoEncoder's corruption). Each makes a
`torch.Generator` on the tensor's device, seeded on the host from the
key's words, so a draw needs no host sync and a card tensor's draw is made
on the card. A step key may carry a draw route (`draws`, set by
`nn/superstep.py` on the keys of the steps it captures): the route then
gives the generator, one registered with the CUDA graph and seeded anew
from the step's key before each replay, so the draw is the same; and a
key derived on the host from such a key (`key_words`) is reported to it,
since no replay could seed that draw. The draws differ from JAX's
(threefry's own stream is not sought); a test or a card check that needs
the reference's draws swaps the function. The JAX package has no kernel
for any of them: they are plain PyTorch on both devices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _words(key) -> np.ndarray:
    return key.words if hasattr(key, "words") else np.asarray(key, np.uint32)


def _route(key):
    """The draw route the key's step key carries, or None."""
    return getattr(getattr(key, "step_key", key), "draws", None)


def key_words(key) -> np.ndarray:
    """A key's uint32[2] words: a `LayerKey`'s, or a raw key's (the
    pretraining step's subkey, and what `fold_in` makes of it), for a key
    derived from them on the host."""
    route = _route(key)
    if route is not None:
        route.derived(key)
    return _words(key)


def _generator(key, device) -> torch.Generator:
    route = _route(key)
    if route is not None:
        gen = route.generator(key, device)
        if gen is not None:
            return gen
    w0, w1 = (int(w) for w in _words(key))
    gen = torch.Generator(device=device)
    gen.manual_seed((w0 << 32) | w1)
    return gen


def draw_keep(key, retain: float, shape, device) -> torch.Tensor:
    """A bool mask of `shape` on `device`, each entry True with probability
    `retain` (the reference's `jax.random.bernoulli(key, retain, shape)`):
    uniform [0, 1) floats from a generator seeded by `key`, below
    `retain`."""
    return torch.rand(tuple(shape), generator=_generator(key, device),
                      device=device) < retain


def draw_uniform(key, low: float, high: float, shape, dtype,
                 device) -> torch.Tensor:
    """Uniform in [low, high) of `shape` and `dtype` (the reference's
    `jax.random.uniform(key, shape, dtype, low, high)`)."""
    u = torch.rand(tuple(shape), generator=_generator(key, device),
                   dtype=dtype, device=device)
    return low + (high - low) * u


def draw_normal(key, shape, dtype, device) -> torch.Tensor:
    """Standard normal of `shape` and `dtype` (the reference's
    `jax.random.normal(key, shape, dtype)`)."""
    return torch.randn(tuple(shape), generator=_generator(key, device),
                       dtype=dtype, device=device)


def draw_bernoulli(key, p, shape, device) -> torch.Tensor:
    """A bool tensor of `shape`, each entry True with probability `p`, a
    float or a tensor of `shape` (the reference's
    `jax.random.bernoulli(key, p, shape)`)."""
    dtype = p.dtype if isinstance(p, torch.Tensor) else torch.float32
    return torch.rand(tuple(shape), generator=_generator(key, device),
                      dtype=dtype, device=device) < p


def _active(retain) -> bool:
    return retain is not None and 0.0 < float(retain) < 1.0


def inverted_dropout(x: torch.Tensor, retain: Optional[float], key,
                     train: bool) -> torch.Tensor:
    """Keep each entry with probability `retain`, scaled by 1/retain, at
    train time (reference `inverted_dropout`, common.py:11-20)."""
    if not train or key is None or not _active(retain):
        return x
    # Plain PyTorch on every device: the JAX package has no dropout kernel.
    keep = draw_keep(key, float(retain), x.shape, x.device)
    return torch.where(keep, x / float(retain), 0.0)


def layer_input_dropout(conf, x: torch.Tensor, key, train: bool):
    """Input dropout, skipped when the layer is in DropConnect mode (the
    two are exclusive; reference common.py:23-29)."""
    if conf.use_drop_connect:
        return x
    return inverted_dropout(x, conf.dropout, key, train)


def maybe_drop_connect(conf, w: torch.Tensor, key, train: bool):
    """DropConnect on an input-weight matrix (the compute-dtype W the layer
    was given): the layer's retain rate applied to W with inverted scaling
    at train time, when `use_drop_connect` is set (reference common.py:32-
    43; never on recurrent weights)."""
    if not conf.use_drop_connect:
        return w
    return inverted_dropout(w, conf.dropout, key, train)


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """Zero masked steps: x [b, t, f], mask [b, t]."""
    if mask is None:
        return x
    return x * mask[..., None]
