"""Model registry.

Counterpart: ``blades_tpu/models/__init__.py:51-102`` (``MODELS``,
``create_model``). Only the MNIST MLP is ported so far; any other name of
the JAX registry raises and names the ``ROADMAP.md`` slice (queue A) that
brings it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

from blades_tpu_torch.models.common import (
    ModelSpec,
    build_fns,
    cross_entropy,
    params_from_jax,
    params_to_jax,
)
from blades_tpu_torch.models.mlp import MLP, create_mnist_model

MODELS: Dict[str, Callable] = {
    "mlp": lambda num_classes=10, sample_shape=(28, 28, 1): MLP(
        math.prod(sample_shape), num_classes
    ),
}


def _unported(name: str) -> str:
    if name in ("cct", "cctnet", "cct_2_3x2_32"):
        return "slice 2 (CCT-2)"
    return "slice 11 (other models)"


def create_model(name: str, num_classes: int = 10, sample_shape=(28, 28, 1)):
    """Resolve a model by registry name into an ``nn.Module``."""
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to blades_tpu_torch yet "
            f"(ROADMAP.md queue A, {_unported(name)}); ported: {sorted(MODELS)}"
        )
    return MODELS[name](num_classes=num_classes, sample_shape=tuple(sample_shape))


__all__ = [
    "MLP",
    "MODELS",
    "ModelSpec",
    "build_fns",
    "create_mnist_model",
    "create_model",
    "cross_entropy",
    "params_from_jax",
    "params_to_jax",
]
