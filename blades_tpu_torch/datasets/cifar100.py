"""CIFAR-100 federated partitioner.

Counterpart: ``blades_tpu/datasets/cifar100.py``: the CIFAR-10 loader on
``cifar-100-python/`` (``train`` and ``test`` pickles, ``fine_labels``, 100
classes) with the CIFAR-100 mean and std.
"""

from __future__ import annotations

from blades_tpu_torch.datasets.augment import make_normalizer
from blades_tpu_torch.datasets.cifar10 import CIFAR10

CIFAR100_MEAN = (0.5071, 0.4865, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)


class CIFAR100(CIFAR10):
    name = "cifar100"
    num_classes = 100
    _dirname = "cifar-100-python"
    _train_files = ["train"]
    _test_file = "test"
    _tar = "cifar-100-python.tar.gz"

    def make_normalize(self):
        return make_normalizer(CIFAR100_MEAN, CIFAR100_STD)
