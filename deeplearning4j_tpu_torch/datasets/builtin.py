"""Built-in datasets (counterpart of `deeplearning4j_tpu/datasets/
builtin.py`): MNIST and Iris, with the same arrays as the reference for
the same arguments.

- MNIST is read from the IDX files (`train-images-idx3-ubyte`, ...,
  optionally gzipped) in the directory `MNIST_DIR` names, when they are
  there. Otherwise `MnistDataSetIterator` builds the reference's
  deterministic synthetic digit set: per-class 7x7 templates from `seed`,
  noise, upsampled to 28x28 (the reference also looks in two directories
  of its own; the port reads only what the caller names).
- Iris is drawn from the classic three-cluster statistics (4 features,
  150 examples).

Images are NHWC float32 in [0, 1] (`flat=True`: [n, 784]); labels one-hot
float32 over 10 classes.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator


def _read_idx(path: str) -> np.ndarray:
    """Parse an IDX file: big-endian magic (its low byte the rank), the
    dims, then uint8 data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_mnist(train: bool) -> Optional[Tuple[str, str]]:
    img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    d = os.environ.get("MNIST_DIR", "")
    if not d:
        return None
    for suffix in ("", ".gz"):
        ip, lp = os.path.join(d, img + suffix), os.path.join(d, lab + suffix)
        if os.path.exists(ip) and os.path.exists(lp):
            return ip, lp
    return None


def _synthetic_mnist(n: int, seed: int,
                     split: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Digit-like data: a smoothed template per class plus noise. The
    templates depend on `seed` alone, so train (split 0) and test (split
    1) share their classes; the noise and labels differ by split."""
    templates = np.random.RandomState(seed).rand(10, 7, 7)
    rng = np.random.RandomState(seed * 1000 + split + 1)
    labels = rng.randint(0, 10, n)
    coarse = templates[labels] + 0.35 * rng.rand(n, 7, 7)
    imgs = np.kron(coarse, np.ones((1, 4, 4)))  # 7x7 -> 28x28
    imgs = np.clip(imgs, 0, 1).astype("float32")
    return imgs.reshape(n, 28, 28, 1), labels


def load_mnist(train: bool = True, num_examples: Optional[int] = None,
               seed: int = 123, flat: bool = False) -> DataSet:
    found = _find_mnist(train)
    if found:
        imgs = _read_idx(found[0]).astype("float32") / 255.0
        labels = _read_idx(found[1]).astype("int64")
        imgs = imgs[..., None]  # NHWC, c = 1
    else:
        n = num_examples or (60000 if train else 10000)
        imgs, labels = _synthetic_mnist(n, seed, split=0 if train else 1)
    if num_examples:
        imgs, labels = imgs[:num_examples], labels[:num_examples]
    if flat:
        imgs = imgs.reshape(imgs.shape[0], -1)
    onehot = np.eye(10, dtype="float32")[labels]
    return DataSet(imgs, onehot)


class MnistDataSetIterator(ListDataSetIterator):
    """MNIST in minibatches (ND4J `MnistDataSetIterator`)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, flat: bool = False, seed: int = 123,
                 shuffle: bool = False):
        ds = load_mnist(train=train, num_examples=num_examples, seed=seed,
                        flat=flat)
        super().__init__(ds, batch_size=batch_size, shuffle=shuffle,
                         seed=seed)


def load_iris(seed: int = 6) -> DataSet:
    """150 examples, 4 features, 3 classes of 50."""
    rng = np.random.RandomState(seed)
    means = np.array([[5.0, 3.4, 1.5, 0.2],
                      [5.9, 2.8, 4.3, 1.3],
                      [6.6, 3.0, 5.6, 2.0]])
    stds = np.array([[0.35, 0.38, 0.17, 0.10],
                     [0.51, 0.31, 0.47, 0.20],
                     [0.64, 0.32, 0.55, 0.27]])
    feats, labels = [], []
    for c in range(3):
        feats.append(means[c] + stds[c] * rng.randn(50, 4))
        labels.extend([c] * 50)
    x = np.concatenate(feats).astype("float32")
    y = np.eye(3, dtype="float32")[np.asarray(labels)]
    idx = rng.permutation(150)
    return DataSet(x[idx], y[idx])


class IrisDataSetIterator(ListDataSetIterator):
    """Iris in minibatches (ND4J `IrisDataSetIterator`)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 seed: int = 6):
        ds = load_iris(seed)
        ds = DataSet(ds.features[:num_examples], ds.labels[:num_examples])
        super().__init__(ds, batch_size=batch_size)
