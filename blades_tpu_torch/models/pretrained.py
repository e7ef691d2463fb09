"""Pretrained-weight registry for the Compact-Transformer zoo.

Counterpart: ``blades_tpu/models/pretrained.py`` (``MODEL_URLS`` :23-40,
``cache_dir`` :43, ``weights_path`` :50, ``fetch_weights`` :60,
``load_pretrained`` :74, ``pretrained_spec`` :81-102). Reference:
``src/blades/models/cifar10/cctnets/cct.py:13-30`` keeps a per-variant URL
table and ``:90-118`` loads the torch ``state_dict`` when
``pretrained=True``. Same contract here: a URL table, an on-disk cache, and
a loader that maps the checkpoint onto the port's params
(``import_torch.py``).

Offline-first: a checkpoint already in the cache directory
(``$BLADES_TPU_WEIGHTS`` or ``~/.cache/blades_tpu``) is used without any
network touch; a download happens only on a cache miss and is refused with
``BLADES_TPU_OFFLINE=1``, whose error says where to place the file
(``utils/fetch.py``).
"""

from __future__ import annotations

import os
from typing import Dict

import torch
from torch import nn

from blades_tpu_torch.models.common import ModelSpec, build_fns
from blades_tpu_torch.models.import_torch import load_torch_checkpoint
from blades_tpu_torch.utils.fetch import fetch_to

# reference cctnets/cct.py:13-30, verbatim variant -> URL table
MODEL_URLS: Dict[str, str] = {
    "cct_7_3x1_32":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/pretrained/cct_7_3x1_32_cifar10_300epochs.pth",
    "cct_7_3x1_32_sine":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/pretrained/cct_7_3x1_32_sine_cifar10_5000epochs.pth",
    "cct_7_3x1_32_c100":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/pretrained/cct_7_3x1_32_cifar100_300epochs.pth",
    "cct_7_3x1_32_sine_c100":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/pretrained/cct_7_3x1_32_sine_cifar100_5000epochs.pth",
    "cct_7_7x2_224_sine":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/pretrained/cct_7_7x2_224_flowers102.pth",
    "cct_14_7x2_224":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/pretrained/cct_14_7x2_224_imagenet.pth",
    "cct_14_7x2_384":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/finetuned/cct_14_7x2_384_imagenet.pth",
    "cct_14_7x2_384_fl":
        "http://ix.cs.uoregon.edu/~alih/compact-transformers/checkpoints/finetuned/cct_14_7x2_384_flowers102.pth",
}


def cache_dir() -> str:
    return os.environ.get(
        "BLADES_TPU_WEIGHTS", os.path.join(os.path.expanduser("~"), ".cache", "blades_tpu")
    )


def weights_path(name: str) -> str:
    """Cache location of a variant's checkpoint (the URL's basename)."""
    if name not in MODEL_URLS:
        raise ValueError(
            f"no pretrained weights registered for {name!r}; available: {sorted(MODEL_URLS)}"
        )
    return os.path.join(cache_dir(), os.path.basename(MODEL_URLS[name]))


def fetch_weights(name: str) -> str:
    """The local checkpoint path, downloading on a cache miss."""
    path = weights_path(name)
    if os.path.exists(path):
        return path
    import urllib.request

    url = MODEL_URLS[name]
    return fetch_to(path, lambda: urllib.request.urlopen(url),
                    f"pretrained weights {name!r} from {url}")


def load_pretrained(name: str, params_template: Dict[str, torch.Tensor]):
    """Pretrained params for ``name``, shaped like ``params_template``."""
    return load_torch_checkpoint(fetch_weights(name), params_template)


def pretrained_spec(name: str, module: nn.Module) -> ModelSpec:
    """A :class:`ModelSpec` whose ``init(generator)`` returns the
    checkpoint's params, so a pretrained model drops in wherever a fresh
    one does (the Simulator, the round engine). The weights are read when
    ``init`` runs: a missing name or file raises there."""
    spec = build_fns(module)
    base_init = spec.init

    def init(generator: torch.Generator):
        return load_pretrained(name, base_init(generator))

    spec.init = init
    return spec
