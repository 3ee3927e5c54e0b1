"""What the layers share (counterpart of
`deeplearning4j_tpu/nn/layers/common.py`): inverted dropout on a layer's
input, DropConnect on its input weights, and step masking.

`conf.dropout` is the RETAIN probability (dl4j 0.x's meaning): a unit is
kept with that probability and scaled by 1/retain; None, 0 and 1 disable
it. It is not `F.dropout`'s drop probability. Kept values are `x / retain`
in x's dtype (bf16 under `mixed_bfloat16`, as the reference divides).

Every Bernoulli draw of the port goes through `draw_keep`, from the
layer's `LayerKey` (`nn/prng.py`): a `torch.Generator` on the tensor's
device, seeded on the host from the reference's key for that layer, so a
draw needs no host sync and a card tensor's mask is drawn on the card. The
masks differ from JAX's (threefry's own stream is not sought); a test or a
card check that needs the reference's masks swaps `draw_keep`. The JAX
package has no kernel for dropout: it is plain PyTorch on both devices.
"""

from __future__ import annotations

from typing import Optional

import torch


def draw_keep(key, retain: float, shape, device) -> torch.Tensor:
    """A bool mask of `shape` on `device`, each entry True with probability
    `retain` (the reference's `jax.random.bernoulli(key, retain, shape)`):
    uniform [0, 1) floats from a generator seeded by `key`, below
    `retain`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key.seed())
    return torch.rand(tuple(shape), generator=gen, device=device) < retain


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
