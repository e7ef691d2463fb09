"""MNIST federated partitioner.

Counterpart: ``blades_tpu/datasets/mnist.py``. Reads local files only, never
downloads: ``mnist.npz`` (``train_x``, ``train_y``, ``test_x``,
``test_y``), or the four IDX files, raw or ``.gz``, under ``data_root`` or
a torchvision-style ``MNIST/raw``. Images are stored uint8 ``[N, 28, 28,
1]`` (NHWC) and normalized on the device in the sampler with
(0.1307, 0.3081).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from blades_tpu_torch.datasets.augment import make_normalizer
from blades_tpu_torch.datasets.base import BaseDataset

MNIST_MEAN, MNIST_STD = (0.1307,), (0.3081,)
_IMAGES_MAGIC, _LABELS_MAGIC = 2051, 2049


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != _IMAGES_MAGIC:
            raise ValueError(f"bad magic {magic} in {path} (IDX images have {_IMAGES_MAGIC})")
        return np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != _LABELS_MAGIC:
            raise ValueError(f"bad magic {magic} in {path} (IDX labels have {_LABELS_MAGIC})")
        return np.frombuffer(f.read(), np.uint8).astype(np.int32)


class MNIST(BaseDataset):
    name = "mnist"
    num_classes = 10

    def load_raw(self):
        npz = os.path.join(self.data_root, "mnist.npz")
        if os.path.exists(npz):
            with np.load(npz) as z:
                return (
                    z["train_x"].reshape(-1, 28, 28, 1).astype(np.uint8),
                    z["train_y"].astype(np.int32),
                    z["test_x"].reshape(-1, 28, 28, 1).astype(np.uint8),
                    z["test_y"].astype(np.int32),
                )
        for sub in ("", "MNIST/raw"):
            d = os.path.join(self.data_root, sub)
            for ext in ("", ".gz"):
                p = os.path.join(d, "train-images-idx3-ubyte" + ext)
                if os.path.exists(p):
                    return (
                        _read_idx_images(p),
                        _read_idx_labels(os.path.join(d, "train-labels-idx1-ubyte" + ext)),
                        _read_idx_images(os.path.join(d, "t10k-images-idx3-ubyte" + ext)),
                        _read_idx_labels(os.path.join(d, "t10k-labels-idx1-ubyte" + ext)),
                    )
        raise FileNotFoundError(
            f"MNIST data not found under {self.data_root!r}. Place the IDX "
            "files (train-images-idx3-ubyte[.gz], ...) or mnist.npz there; "
            "this build performs no network downloads. For offline smoke "
            "runs use blades_tpu_torch.datasets.Synthetic instead."
        )

    def make_normalize(self):
        return make_normalizer(MNIST_MEAN, MNIST_STD)
