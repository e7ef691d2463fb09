"""Synthetic classification dataset (offline stand-in).

Counterpart: ``blades_tpu/datasets/synthetic.py:18-52``, copied: the same
seed gives the same arrays. Class-conditional Gaussian images with a
learnable signal, shaped like MNIST or CIFAR on request.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from blades_tpu_torch.datasets.base import BaseDataset


class Synthetic(BaseDataset):
    name = "synthetic"

    def __init__(
        self,
        num_classes: int = 10,
        sample_shape: Tuple[int, ...] = (28, 28, 1),
        train_size: int = 2000,
        test_size: int = 400,
        noise: float = 0.5,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.num_classes = int(num_classes)
        self.sample_shape = tuple(sample_shape)
        self.train_size = int(train_size)
        self.test_size = int(test_size)
        self.noise = float(noise)

    def load_raw(self):
        rng = np.random.RandomState(self.seed + 1234)
        # one random unit "prototype" per class; images = prototype + noise
        protos = rng.randn(self.num_classes, *self.sample_shape).astype(np.float32)
        protos /= np.sqrt((protos**2).sum(axis=tuple(range(1, protos.ndim)), keepdims=True))

        def make(n):
            y = rng.randint(0, self.num_classes, size=n)
            x = protos[y] + self.noise * rng.randn(n, *self.sample_shape).astype(
                np.float32
            )
            return x.astype(np.float32), y.astype(np.int32)

        train_x, train_y = make(self.train_size)
        test_x, test_y = make(self.test_size)
        return train_x, train_y, test_x, test_y
