"""Datasets (counterpart: ``blades_tpu/datasets/__init__.py``): the
partitioners, ``BaseDataset``, ``FLDataset``, ``Synthetic``, and the
MNIST, CIFAR-10, CIFAR-100 and custom loaders, which read local files only.
Images are stored uint8 on the device and augmented and normalized in the
round's sampler (``augment.py``). ``SyntheticText`` (``text.py``) feeds the
text models: an int32 token store with a padding id, which the sampler
gathers as it is."""

from blades_tpu_torch.datasets.base import (
    BaseDataset,
    partition_dirichlet,
    partition_iid,
)
from blades_tpu_torch.datasets.cifar10 import CIFAR10
from blades_tpu_torch.datasets.cifar100 import CIFAR100
from blades_tpu_torch.datasets.custom import CustomTensorDataset
from blades_tpu_torch.datasets.fl import FLDataset
from blades_tpu_torch.datasets.mnist import MNIST
from blades_tpu_torch.datasets.synthetic import Synthetic
from blades_tpu_torch.datasets.text import SyntheticText

__all__ = [
    "BaseDataset",
    "CIFAR10",
    "CIFAR100",
    "CustomTensorDataset",
    "FLDataset",
    "MNIST",
    "Synthetic",
    "SyntheticText",
    "partition_dirichlet",
    "partition_iid",
]
