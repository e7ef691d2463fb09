"""Noise attack: byzantine rows replaced by i.i.d. Gaussian noise.

Counterpart: ``blades_tpu/attackers/noise.py:17-26``: ``mean + std * N(0, 1)``
of the update matrix's shape, kept on the byzantine rows. The normals come
from :func:`draw_normals` on the round's attack generator
(``utils/rng.py:ATTACK``); torch cannot reproduce ``jax.random.normal``'s
bits, so tests hand both packages the same draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from blades_tpu_torch.attackers.base import Attack


def draw_normals(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normals of ``shape`` in float32, drawn on the generator's
    device (a fresh default generator when None) and moved to ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    z = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return z.to(device)


class Noise(Attack):
    def __init__(self, mean: float = 0.1, std: float = 0.1):
        self.mean = float(mean)
        self.std = float(std)

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        z = draw_normals(updates.shape, generator, updates.device).to(updates.dtype)
        return torch.where(byz_mask[:, None], self.mean + self.std * z, updates), state
