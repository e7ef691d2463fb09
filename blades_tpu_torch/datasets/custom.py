"""Custom in-memory dataset.

Counterpart: ``blades_tpu/datasets/custom.py`` (``CustomTensorDataset``):
``(x, y)`` arrays with an optional transform and normalizer, partitioned
into an :class:`~blades_tpu_torch.datasets.fl.FLDataset` like any other.
Without test arrays the train arrays serve as the test set.

``transform`` is the port's batched form, ``(x [N, ...], generator) -> x``
(as ``augment.cifar_train_transform``), drawing from the sampler's
generator; the JAX package's is per image, ``(key, x) -> x``, and vmapped.
``normalize`` is ``(x) -> x`` (``augment.make_normalizer`` gives one).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from blades_tpu_torch.datasets.base import BaseDataset


class CustomTensorDataset(BaseDataset):
    name = "custom"

    def __init__(
        self,
        train_x: np.ndarray,
        train_y: np.ndarray,
        test_x: Optional[np.ndarray] = None,
        test_y: Optional[np.ndarray] = None,
        transform: Optional[Callable] = None,
        normalize: Optional[Callable] = None,
        num_classes: Optional[int] = None,
        **kwargs,
    ):
        kwargs.setdefault("cache", False)
        super().__init__(**kwargs)
        self._train = (np.asarray(train_x), np.asarray(train_y))
        if test_x is None:
            test_x, test_y = train_x, train_y
        self._test = (np.asarray(test_x), np.asarray(test_y))
        self._transform = transform
        self._normalize = normalize
        self.num_classes = (
            int(num_classes) if num_classes is not None else int(np.max(train_y)) + 1
        )

    def load_raw(self):
        return (*self._train, *self._test)

    def make_transform(self):
        return self._transform

    def make_normalize(self):
        return self._normalize
