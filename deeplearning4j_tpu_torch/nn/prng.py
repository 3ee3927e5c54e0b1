"""The train-time key chain, in the JAX package's own terms: its keys are
threefry2x32 keys (`uint32[2]`), made by `jax.random.PRNGKey`, advanced by
`jax.random.split` and specialised per layer by `jax.random.fold_in`. This
module computes the same keys with Python integers on the host, so a key
the port saves in a checkpoint means what the reference's means.

The port draws its dropout bits from a `torch.Generator` seeded from such a
key (`nn/layers/common.py`), not from threefry's own stream: the keys agree
with the reference's, the masks drawn from them do not.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """One block of threefry2x32 (20 rounds), as `jax.random`'s
    `threefry2x32_p` computes it."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & _M, (x1 + k1) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` (the default threefry key, as the
    reference's tests make it with 64-bit ints on): the seed's high and low
    32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & _M, seed & _M], np.uint32)


def _words(key) -> Tuple[int, int]:
    return int(key[0]), int(key[1])


def split(key) -> Tuple[np.ndarray, np.ndarray]:
    """`jax.random.split(key)` (two keys; threefry's partitionable split,
    JAX's default): key i is the block of counter (0, i)."""
    k0, k1 = _words(key)
    return tuple(np.array(threefry2x32(k0, k1, 0, i), np.uint32)
                 for i in (0, 1))


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a 32-bit `data`."""
    k0, k1 = _words(key)
    return np.array(threefry2x32(k0, k1, 0, int(data) & _M), np.uint32)


class LayerKey:
    """The key of one layer's draws in one forward: the reference's
    `fold_in(step_key, index)` (index: the layer's position in a
    MultiLayerNetwork, the vertex's in a graph's topological order), then
    `split`'s parts along `path`. The words are computed only when a layer
    draws."""

    __slots__ = ("step_key", "index", "path")

    def __init__(self, step_key, index: int, path: Tuple[int, ...] = ()):
        self.step_key, self.index, self.path = step_key, index, path

    def split(self) -> Tuple["LayerKey", "LayerKey"]:
        return tuple(LayerKey(self.step_key, self.index, self.path + (p,))
                     for p in (0, 1))

    @property
    def words(self) -> np.ndarray:
        key = fold_in(self.step_key, self.index)
        for p in self.path:
            key = split(key)[p]
        return key
