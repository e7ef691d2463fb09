"""Sign-flipping attack: byzantine clients negate every gradient step.

Counterpart: ``blades_tpu/attackers/signflipping.py:17-22``: a signed scale
on each local step's gradients, here on a chunk's ``{name: [k, ...]}``
gradient dict, gated per row by the chunk's byzantine mask.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.attackers.base import Attack


class Signflipping(Attack):
    trains_dishonestly = True

    def on_grads(self, grads, byz_mask, client_idx=None):
        sign = torch.where(byz_mask, -1.0, 1.0)
        return {
            n: g * sign.to(g.dtype).view(-1, *([1] * (g.dim() - 1)))
            for n, g in grads.items()
        }
