"""CIFAR-10 federated partitioner.

Counterpart: ``blades_tpu/datasets/cifar10.py``. Reads the python-pickle
batches (``cifar-10-batches-py/``) under ``data_root`` or
``data_root/cifar10``, extracting ``cifar-10-python.tar.gz`` there if only
the archive is present; never downloads. Images are stored uint8 NHWC on
the device; the sampler crops, flips and erases them
(``augment.cifar_train_transform``) and normalizes them with the CIFAR-10
mean and std.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from blades_tpu_torch.datasets.augment import cifar_train_transform, make_normalizer
from blades_tpu_torch.datasets.base import BaseDataset

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)


def _load_batch(path: str) -> tuple:
    # the batches are python pickles: load only files placed under data_root
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    y = np.asarray(d.get(b"labels", d.get(b"fine_labels")), np.int32)
    return x.astype(np.uint8), y


class CIFAR10(BaseDataset):
    name = "cifar10"
    num_classes = 10
    _dirname = "cifar-10-batches-py"
    _train_files = [f"data_batch_{i}" for i in range(1, 6)]
    _test_file = "test_batch"
    _tar = "cifar-10-python.tar.gz"

    def _batch_dir(self) -> str:
        for base in (self.data_root, os.path.join(self.data_root, "cifar10")):
            d = os.path.join(base, self._dirname)
            if os.path.isdir(d):
                return d
            tar = os.path.join(base, self._tar)
            if os.path.exists(tar):
                with tarfile.open(tar) as tf:
                    tf.extractall(base, filter="data")
                return d
        raise FileNotFoundError(
            f"{self.name} data not found under {self.data_root!r}. Place "
            f"{self._dirname}/ or {self._tar} there; this build performs no "
            "network downloads. For offline smoke runs use "
            "blades_tpu_torch.datasets.Synthetic instead."
        )

    def load_raw(self):
        d = self._batch_dir()
        xs, ys = zip(*(_load_batch(os.path.join(d, f)) for f in self._train_files))
        test_x, test_y = _load_batch(os.path.join(d, self._test_file))
        return np.concatenate(xs), np.concatenate(ys), test_x, test_y

    def make_transform(self):
        return cifar_train_transform

    def make_normalize(self):
        return make_normalizer(CIFAR10_MEAN, CIFAR10_STD)
