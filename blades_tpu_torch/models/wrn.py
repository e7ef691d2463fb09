"""WideResNet-28-10, GroupNorm-normalized (BASELINE.md config 5).

Counterpart: ``blades_tpu/models/wrn.py`` — ``WideBlock`` (:22-46),
``WideResNet`` (:49-69), ``wrn_28_10`` (:72). Pre-activation wide residual
blocks (Zagoruyko & Komodakis), GroupNorm for the same pure-function
reason as ``resnet.py``.

A block computes ``y = relu(norm(x))``; its shortcut is a 1x1 conv of
``y`` where the width or the stride changes, else the raw ``x``; then
conv3x3 (the block's stride), ``relu(norm)``, dropout, conv3x3, and the
sum. ``(depth - 4) / 6`` blocks per stage, widths ``16k, 32k, 64k``; after
the stages a final ``relu(norm(x))``, global average pool, Dense head.

flax names a block's leaves in creation order, and the shortcut's conv is
created before the two 3x3 convs: a projection block holds ``Conv_0``
(the shortcut), ``Conv_1``, ``Conv_2``; an identity block ``Conv_0``,
``Conv_1``; both ``GroupNorm_0`` (on ``x``) and ``GroupNorm_1``.

``dropout > 0`` declares one noise site per block, ``blocks.{i}.drop``:
flax's ``nn.Dropout`` mask over the block's ``[B, H, W, C]`` activation
(NHWC, as the JAX package draws it), permuted here to NCHW. The site's
spatial size follows from the image size, so the model is built for one
(``image_hw``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from blades_tpu_torch.models.common import NoiseSites, dropout
from blades_tpu_torch.models.resnet import (
    GroupNorm,
    Paths,
    conv1x1,
    conv3x3,
    conv_path,
    dense_path,
    init_conv_norm_dense,
    norm_path,
)

Masks = Optional[Dict[str, torch.Tensor]]


class WideBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1, rate: float = 0.0,
                 out_hw: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.proj = conv1x1(cin, filters, stride) if cin != filters or stride != 1 else None
        self.conv1 = conv3x3(cin, filters, stride)
        self.norm2 = GroupNorm(filters)
        self.conv2 = conv3x3(filters, filters)
        self.rate, self.out_hw = rate, tuple(out_hw)

    def noise_sites(self, batch: int) -> NoiseSites:
        if self.rate == 0.0:
            return {}
        return {"drop": ((batch, *self.out_hw, self.conv1.out_channels), 1.0 - self.rate)}

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.relu(self.norm1(x))
        shortcut = x if self.proj is None else self.proj(y)
        y = F.relu(self.norm2(self.conv1(y)))
        if mask is not None:
            mask = mask.permute(0, 3, 1, 2)  # the NHWC site -> NCHW
        y = dropout(y, mask, self.rate)
        return self.conv2(y) + shortcut

    def jax_paths(self, prefix: str, path: Tuple[str, ...]) -> Paths:
        convs = ["conv1", "conv2"] if self.proj is None else ["proj", "conv1", "conv2"]
        paths = {**norm_path(f"{prefix}.norm1", path + ("GroupNorm_0",)),
                 **norm_path(f"{prefix}.norm2", path + ("GroupNorm_1",))}
        for i, name in enumerate(convs):
            paths.update(conv_path(f"{prefix}.{name}", path + (f"Conv_{i}",)))
        return paths


class WideResNet(nn.Module):
    def __init__(self, depth: int = 28, widen_factor: int = 10, num_classes: int = 10,
                 dropout: float = 0.0, in_channels: int = 3,
                 image_hw: Tuple[int, int] = (32, 32)):
        super().__init__()
        n = (depth - 4) // 6
        widths = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        self.stem = conv3x3(in_channels, widths[0])
        blocks, cin, hw = [], widths[0], tuple(image_hw)
        for stage in range(3):
            for b in range(n):
                stride = 2 if stage > 0 and b == 0 else 1
                hw = tuple((s + 2 - 3) // stride + 1 for s in hw)
                blocks.append(WideBlock(cin, widths[stage + 1], stride, dropout, hw))
                cin = widths[stage + 1]
        self.blocks = nn.ModuleList(blocks)
        self.norm = GroupNorm(cin)
        self.fc = nn.Linear(cin, num_classes)

    def noise_sites(self, batch: int) -> NoiseSites:
        return {f"blocks.{i}.{k}": v for i, block in enumerate(self.blocks)
                for k, v in block.noise_sites(batch).items()}

    def forward(self, x: torch.Tensor, noise: Masks = None) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        for i, block in enumerate(self.blocks):
            x = block(x, None if noise is None or block.rate == 0.0
                      else noise[f"blocks.{i}.drop"])
        x = F.relu(self.norm(x))
        return self.fc(x.mean(dim=(2, 3)))

    def jax_paths(self) -> Paths:
        """torch name -> (flax path, perm)."""
        paths = conv_path("stem", ("Conv_0",))
        for i, block in enumerate(self.blocks):
            paths.update(block.jax_paths(f"blocks.{i}", (f"WideBlock_{i}",)))
        paths.update(norm_path("norm", ("GroupNorm_0",)))
        paths.update(dense_path("fc", ("Dense_0",)))
        return paths

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return init_conv_norm_dense(self, generator)


def wrn_28_10(num_classes: int = 10, **kw) -> WideResNet:
    return WideResNet(depth=28, widen_factor=10, num_classes=num_classes, **kw)
