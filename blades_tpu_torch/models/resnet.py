"""ResNet-18/34, CIFAR variant, GroupNorm-normalized.

Counterpart: ``blades_tpu/models/resnet.py`` — ``_norm`` (:20),
``BasicBlock`` (:24-45), ``ResNet`` (:48-67), ``ResNet18`` / ``ResNet34``
(:70-77). BASELINE.md configs 2-4 name ResNet-18 at K=100 and K=1000 on
CIFAR-10; GroupNorm stands in for BatchNorm so the model stays a pure
``params -> logits`` function under the vmapped client step.

CIFAR stem: a 3x3 conv with no max-pool, then GroupNorm and ReLU; four
stages of :class:`BasicBlock` (the first block of stages 2-4 strides by 2
and doubles the width); global average pool; Dense head. No conv has a
bias. Each norm is a GroupNorm of ``min(8, C)`` groups. A block whose
output shape differs from its input's takes a projection shortcut (1x1
conv, stride as the block's, then GroupNorm); since the width doubles
exactly where the stride is 2, that is where the channels change.

The module takes NHWC input, as the flax model does, and runs NCHW inside;
its weights are in torch's layout (Conv OIHW, Dense ``[out, in]``) and
:meth:`ResNet.jax_paths` maps them onto flax's automatic names: inside a
block ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1`` and, the
projection being created last, ``Conv_2``, ``GroupNorm_2``. ``ravel_pytree``
sorts those names as strings, so ResNet-34's ``BasicBlock_10`` comes before
``BasicBlock_2`` in the flat vector; :func:`~blades_tpu_torch.ops.pytree.make_layout`
sorts the same way.

Padding: the 3x3 convs pad ``[(1, 1), (1, 1)]`` explicitly (``padding=1``);
the 1x1 shortcut uses flax's default ``'SAME'``, which is 0 for a 1x1
kernel at any size and stride (32 -> 16, and 7 -> 4 on MNIST's 28x28).
The model draws nothing in training (no noise sites).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from blades_tpu_torch.models.common import kaiming_normal_, lecun_normal_
from blades_tpu_torch.ops.pytree import CONV2D, DENSE

#: flax ``nn.GroupNorm``'s epsilon; torch's default is 1e-5
GN_EPS = 1e-6

Paths = Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=min(8, C))`` on NCHW activations:
    statistics over each group's channels and the spatial axes, epsilon
    1e-6, a per-channel scale and bias. ``F.group_norm`` keeps its
    statistics in float32 for bf16 activations and returns their dtype, as
    flax's ``force_float32_reductions`` does; it takes the variance in one
    pass where flax takes ``E[x^2] - E[x]^2`` clamped at 0, which agree to
    float32 rounding at these activations (``tests/test_torch_resnet.py``).

    The input is made NCHW-contiguous first (a no-op where it is), so that
    every activation after a norm is too: the CPU's convs (oneDNN) hand
    back channels-last outputs for channels-last or one-channel inputs and
    for some bf16 convs, and with those the CPU's GroupNorm under ``vmap``
    refuses the layout and its backward of a 1x1 stride-2 conv corrupts the
    heap (torch 2.13)."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        self.num_groups = min(groups, channels)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.contiguous(), self.num_groups, self.weight, self.bias, GN_EPS)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)


def conv1x1(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, padding=0, bias=False)


def conv_path(prefix: str, path: Tuple[str, ...]) -> Paths:
    return {f"{prefix}.weight": (path + ("kernel",), CONV2D)}


def norm_path(prefix: str, path: Tuple[str, ...]) -> Paths:
    return {f"{prefix}.weight": (path + ("scale",), ()), f"{prefix}.bias": (path + ("bias",), ())}


def dense_path(prefix: str, path: Tuple[str, ...]) -> Paths:
    return {f"{prefix}.weight": (path + ("kernel",), DENSE),
            f"{prefix}.bias": (path + ("bias",), ())}


def init_conv_norm_dense(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """flax's inits in module order: conv kernels ``kaiming_normal``
    (truncated, fan_in = kh*kw*in), GroupNorm scale 1 and bias 0, Dense
    kernels ``lecun_normal`` and biases 0."""
    params = {n: torch.zeros(p.shape) for n, p in module.named_parameters()}
    for name, m in module.named_modules():
        w = params.get(f"{name}.weight")
        if isinstance(m, nn.Conv2d):
            kaiming_normal_(w, math.prod(w.shape[1:]), generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(w, m.in_features, generator)
        elif isinstance(m, GroupNorm):
            w.fill_(1.0)
    return params


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(cin, filters, stride)
        self.norm1 = GroupNorm(filters)
        self.conv2 = conv3x3(filters, filters)
        self.norm2 = GroupNorm(filters)
        self.proj = conv1x1(cin, filters, stride) if cin != filters else None
        self.proj_norm = GroupNorm(filters) if cin != filters else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        return F.relu(y + residual)

    def jax_paths(self, prefix: str, path: Tuple[str, ...]) -> Paths:
        paths = {**conv_path(f"{prefix}.conv1", path + ("Conv_0",)),
                 **norm_path(f"{prefix}.norm1", path + ("GroupNorm_0",)),
                 **conv_path(f"{prefix}.conv2", path + ("Conv_1",)),
                 **norm_path(f"{prefix}.norm2", path + ("GroupNorm_1",))}
        if self.proj is not None:
            paths.update(conv_path(f"{prefix}.proj", path + ("Conv_2",)))
            paths.update(norm_path(f"{prefix}.proj_norm", path + ("GroupNorm_2",)))
        return paths


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 10, width: int = 64,
                 in_channels: int = 3):
        super().__init__()
        self.stem = conv3x3(in_channels, width)
        self.stem_norm = GroupNorm(width)
        blocks, cin, filters = [], width, width
        for stage, n in enumerate(stage_sizes):
            for b in range(n):
                blocks.append(BasicBlock(cin, filters, 2 if stage > 0 and b == 0 else 1))
                cin = filters
            filters *= 2
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.stem_norm(self.stem(x.permute(0, 3, 1, 2))))  # NHWC -> NCHW
        for block in self.blocks:
            x = block(x)
        return self.fc(x.mean(dim=(2, 3)))

    def jax_paths(self) -> Paths:
        """torch name -> (flax path, perm)."""
        paths = {**conv_path("stem", ("Conv_0",)), **norm_path("stem_norm", ("GroupNorm_0",))}
        for i, block in enumerate(self.blocks):
            paths.update(block.jax_paths(f"blocks.{i}", (f"BasicBlock_{i}",)))
        paths.update(dense_path("fc", ("Dense_0",)))
        return paths

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return init_conv_norm_dense(self, generator)


def ResNet18(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(2, 2, 2, 2), num_classes=num_classes, **kw)


def ResNet34(num_classes: int = 10, **kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)
