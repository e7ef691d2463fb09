"""Model registry.

Counterpart: ``blades_tpu/models/__init__.py:51-102`` (``MODELS``,
``create_model``). Ported: the MNIST MLP and the CCT family (CCT-2, -4, -6,
-7, CVT-7, ViT-Lite-7); any other name of the JAX registry raises and names
the ``ROADMAP.md`` slice (queue A) that brings it. ``create_model`` sizes a
model from the data's ``sample_shape`` (``H, W, C``): the MLP's input width,
a CCT's image size (its token count) and input channels.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

from blades_tpu_torch.models.cct import (
    CCT,
    CCTNet,
    cct_2_3x2_32,
    cct_4_3x2_32,
    cct_6_3x1_32,
    cct_7_3x1_32,
    cvt_7_4_32,
    vit_lite_7_4_32,
)
from blades_tpu_torch.models.common import (
    ModelSpec,
    build_fns,
    cross_entropy,
    params_from_jax,
    params_to_jax,
    state_from_jax,
)
from blades_tpu_torch.models.mlp import MLP, create_mnist_model


def _image_model(factory: Callable) -> Callable:
    def make(num_classes=10, sample_shape=(32, 32, 3)):
        return factory(num_classes=num_classes, img_size=sample_shape[0],
                       in_channels=sample_shape[-1])

    return make


MODELS: Dict[str, Callable] = {
    "mlp": lambda num_classes=10, sample_shape=(28, 28, 1): MLP(
        math.prod(sample_shape), num_classes
    ),
    "cct": _image_model(cct_2_3x2_32),
    "cctnet": _image_model(cct_2_3x2_32),
    "cct_2_3x2_32": _image_model(cct_2_3x2_32),
    "cct_4_3x2_32": _image_model(cct_4_3x2_32),
    "cct_6_3x1_32": _image_model(cct_6_3x1_32),
    "cct_7_3x1_32": _image_model(cct_7_3x1_32),
    "cvt_7_4_32": _image_model(cvt_7_4_32),
    "vit_lite_7_4_32": _image_model(vit_lite_7_4_32),
}


def create_model(name: str, num_classes: int = 10, sample_shape=(28, 28, 1)):
    """Resolve a model by registry name into an ``nn.Module``."""
    if name not in MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to blades_tpu_torch yet "
            f"(ROADMAP.md queue A, slice 11 (other models)); ported: {sorted(MODELS)}"
        )
    return MODELS[name](num_classes=num_classes, sample_shape=tuple(sample_shape))


__all__ = [
    "CCT",
    "CCTNet",
    "MLP",
    "MODELS",
    "ModelSpec",
    "build_fns",
    "cct_2_3x2_32",
    "cct_4_3x2_32",
    "cct_6_3x1_32",
    "cct_7_3x1_32",
    "create_mnist_model",
    "create_model",
    "cross_entropy",
    "cvt_7_4_32",
    "params_from_jax",
    "params_to_jax",
    "state_from_jax",
    "vit_lite_7_4_32",
]
