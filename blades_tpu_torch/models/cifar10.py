"""Reference-path alias: ``blades.models.cifar10`` -> here.

Counterpart: ``blades_tpu/models/cifar10.py``, which re-exports the CCT
family as the reference exposes it (``from blades.models.cifar10 import
CCTNet``, ``src/blades/models/cifar10/cct.py:6-16``); migrating code keeps
working with the package name swapped.
"""

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

__all__ = [
    "CCT",
    "CCTNet",
    "cct_2_3x2_32",
    "cct_4_3x2_32",
    "cct_6_3x1_32",
    "cct_7_3x1_32",
    "cvt_7_4_32",
    "vit_lite_7_4_32",
]
