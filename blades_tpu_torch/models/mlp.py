"""MNIST MLP: flatten -> 784->64 relu -> 64->128 relu -> 128->10 log_softmax.

Counterpart: ``blades_tpu/models/mlp.py:15-31`` (``MLP``,
``create_mnist_model``). flax names the layers ``Dense_0..2`` in call order
and keeps each kernel ``[in, out]``; :meth:`MLP.jax_paths` maps this
module's ``nn.Linear`` parameters onto those names, and the init draws from
the same distributions as flax's defaults (``lecun_normal`` kernels, zero
biases), from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from blades_tpu_torch.models.common import build_fns, lecun_normal_
from blades_tpu_torch.ops.pytree import DENSE


class MLP(nn.Module):
    def __init__(
        self,
        in_features: int = 784,
        num_classes: int = 10,
        hidden: Tuple[int, ...] = (64, 128),
    ):
        super().__init__()
        dims = (in_features, *hidden, num_classes)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)  # NHWC flattened, as in flax
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return F.log_softmax(self.layers[-1](x), dim=-1)

    def jax_paths(self) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]]:
        paths = {}
        for i in range(len(self.layers)):
            paths[f"layers.{i}.weight"] = ((f"Dense_{i}", "kernel"), DENSE)
            paths[f"layers.{i}.bias"] = ((f"Dense_{i}", "bias"), ())
        return paths

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        params = {}
        for i, layer in enumerate(self.layers):
            w = torch.empty(layer.out_features, layer.in_features)
            params[f"layers.{i}.weight"] = lecun_normal_(w, layer.in_features, generator)
            params[f"layers.{i}.bias"] = torch.zeros(layer.out_features)
        return params


def create_mnist_model(sample_shape=(28, 28, 1), num_classes: int = 10):
    """The MLP's :class:`ModelSpec` with cross-entropy wired in."""
    return build_fns(MLP(math.prod(sample_shape), num_classes))
