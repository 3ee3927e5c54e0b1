"""Gradient normalization and clipping (counterpart of
`deeplearning4j_tpu/ops/grad_norm.py`, the reference's
`LayerUpdater.java:181-221` modes), over one layer's `{name: grad}`:
"per layer" reduces over every leaf, "per param type" over each leaf."""

from __future__ import annotations

import torch

MODES = ("none", "renormalizel2perlayer", "renormalizel2perparamtype",
         "clipelementwiseabsolutevalue", "clipl2perlayer",
         "clipl2perparamtype")
_EPS = 1e-8


def _layer_l2(grads) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))


def _clip_factor(norm, threshold):
    return torch.where(norm > threshold, threshold / (norm + _EPS),
                       torch.ones_like(norm))


def normalize_layer_gradients(grads, mode, threshold: float = 1.0):
    m = "none" if mode is None else str(mode).lower()
    if m == "none":
        return grads
    if m == "renormalizel2perlayer":
        norm = _layer_l2(grads)
        return {k: g / (norm + _EPS) for k, g in grads.items()}
    if m == "renormalizel2perparamtype":
        return {k: g / (torch.linalg.vector_norm(g) + _EPS)
                for k, g in grads.items()}
    if m == "clipelementwiseabsolutevalue":
        return {k: g.clamp(-threshold, threshold) for k, g in grads.items()}
    if m == "clipl2perlayer":
        scale = _clip_factor(_layer_l2(grads), threshold)
        return {k: g * scale for k, g in grads.items()}
    if m == "clipl2perparamtype":
        return {k: g * _clip_factor(torch.linalg.vector_norm(g), threshold)
                for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization: {mode!r}")
