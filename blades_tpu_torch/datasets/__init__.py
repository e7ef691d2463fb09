"""Datasets (counterpart: ``blades_tpu/datasets/__init__.py``). Ported so far:
the partitioners, ``BaseDataset``, ``Synthetic`` and ``FLDataset``; MNIST,
CIFAR-10/100, custom and text data come with ``ROADMAP.md`` queue A,
slice 4."""

from blades_tpu_torch.datasets.base import (
    BaseDataset,
    partition_dirichlet,
    partition_iid,
)
from blades_tpu_torch.datasets.fl import FLDataset
from blades_tpu_torch.datasets.synthetic import Synthetic

__all__ = [
    "BaseDataset",
    "FLDataset",
    "Synthetic",
    "partition_dirichlet",
    "partition_iid",
]
