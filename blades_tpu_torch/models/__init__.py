"""Model registry.

Counterpart: ``blades_tpu/models/__init__.py:51-102`` (``MODELS``,
``create_model``). Every name of the JAX registry resolves: the MNIST MLP,
the CCT family (CCT-2, -4, -6, -7, CVT-7, ViT-Lite-7), ResNet-18/34,
WideResNet-28-10, the text families ``text_{cct,cvt,vit,transformer}_{2,4,6}``
and ``long_text_transformer`` (``text.py``). ``create_model`` sizes a model
from the data's ``sample_shape``: the MLP's input width, a CCT's image size
(its token count), a WideResNet's dropout sites, every image model's input
channels (``H, W, C``), and a text model's token length (``(L,)``); without
one, each model takes its own default. Extra keyword arguments go to the
factory where the JAX registry passes them (the CCT and text families,
``wrn_28_10``) and are dropped where it drops them (``mlp``, ``resnet18``,
``resnet34``). ``pretrained=`` returns a :class:`ModelSpec` whose ``init``
loads a checkpoint (``pretrained.py``).
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
from blades_tpu_torch.models.pretrained import MODEL_URLS, pretrained_spec
from blades_tpu_torch.models.resnet import ResNet, ResNet18, ResNet34
from blades_tpu_torch.models.text import (
    TextCCT,
    long_text_transformer,
    text_cct_2,
    text_cct_4,
    text_cct_6,
    text_cvt_2,
    text_cvt_4,
    text_cvt_6,
    text_transformer_2,
    text_transformer_4,
    text_transformer_6,
    text_vit_2,
    text_vit_4,
    text_vit_6,
)
from blades_tpu_torch.models.wrn import WideResNet, wrn_28_10


def _image_model(factory: Callable) -> Callable:
    def make(num_classes=10, sample_shape=(32, 32, 3), **kw):
        return factory(num_classes=num_classes, img_size=sample_shape[0],
                       in_channels=sample_shape[-1], **kw)

    return make


def _text_model(factory: Callable) -> Callable:
    def make(num_classes=10, sample_shape=(64,), **kw):
        if len(sample_shape) != 1:
            raise ValueError(f"a text model takes rows of token ids, sample shape (L,); "
                             f"got {tuple(sample_shape)}")
        return factory(num_classes=num_classes, seq_len=sample_shape[0], **kw)

    return make


_TEXT = (text_cct_2, text_cct_4, text_cct_6, text_cvt_2, text_cvt_4, text_cvt_6, text_vit_2,
         text_vit_4, text_vit_6, text_transformer_2, long_text_transformer, text_transformer_4,
         text_transformer_6)


MODELS: Dict[str, Callable] = {
    "mlp": lambda num_classes=10, sample_shape=(28, 28, 1), **kw: MLP(
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
    "resnet18": lambda num_classes=10, sample_shape=(32, 32, 3), **kw: ResNet18(
        num_classes, in_channels=sample_shape[-1]),
    "resnet34": lambda num_classes=10, sample_shape=(32, 32, 3), **kw: ResNet34(
        num_classes, in_channels=sample_shape[-1]),
    "wrn_28_10": lambda num_classes=10, sample_shape=(32, 32, 3), **kw: wrn_28_10(
        num_classes, in_channels=sample_shape[-1], image_hw=tuple(sample_shape[:2]), **kw),
    **{f.__name__: _text_model(f) for f in _TEXT},
}


def create_model(name: str, num_classes: int = 10, sample_shape=None, pretrained=False,
                 **kwargs):
    """Resolve a model by registry name into an ``nn.Module``.

    ``pretrained=True`` returns a :class:`ModelSpec` whose ``init`` yields
    the registered checkpoint's weights (reference ``pretrained=True``,
    ``cctnets/cct.py:90-118``); a string picks another registry entry for
    the same architecture (``create_model("cct_7_3x1_32", num_classes=100,
    pretrained="cct_7_3x1_32_c100")``). Weights come from the local cache,
    downloading only on a miss (``pretrained.py``)."""
    try:
        factory = MODELS[name]
    except KeyError:
        raise ValueError(f"Unknown model {name!r}; available: {sorted(MODELS)}") from None
    if sample_shape is not None:
        kwargs["sample_shape"] = tuple(sample_shape)
    model = factory(num_classes=num_classes, **kwargs)
    if pretrained:
        return pretrained_spec(pretrained if isinstance(pretrained, str) else name, model)
    return model


__all__ = [
    "CCT",
    "CCTNet",
    "MLP",
    "MODELS",
    "MODEL_URLS",
    "ModelSpec",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "TextCCT",
    "WideResNet",
    "build_fns",
    "cct_2_3x2_32",
    "cct_4_3x2_32",
    "cct_6_3x1_32",
    "cct_7_3x1_32",
    "create_mnist_model",
    "create_model",
    "cross_entropy",
    "cvt_7_4_32",
    "long_text_transformer",
    "params_from_jax",
    "params_to_jax",
    "state_from_jax",
    "text_cct_2",
    "text_cct_4",
    "text_cct_6",
    "text_cvt_2",
    "text_cvt_4",
    "text_cvt_6",
    "text_transformer_2",
    "text_transformer_4",
    "text_transformer_6",
    "text_vit_2",
    "text_vit_4",
    "text_vit_6",
    "vit_lite_7_4_32",
    "wrn_28_10",
]
