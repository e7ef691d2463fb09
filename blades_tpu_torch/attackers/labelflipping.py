"""Label-flipping attack: ``y -> num_classes - 1 - y`` on byzantine clients.

Counterpart: ``blades_tpu/attackers/labelflipping.py:16-24``, a
``torch.where`` on a chunk's ``[k, B]`` labels gated per row by the chunk's
byzantine mask. The Simulator fills ``num_classes`` from the dataset, as
``blades_tpu/simulator.py:197-198`` does.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.attackers.base import Attack


class Labelflipping(Attack):
    trains_dishonestly = True

    def __init__(self, num_classes: int = 10):
        self.num_classes = int(num_classes)

    def on_batch(self, x, y, byz_mask, *, num_classes, generator=None, client_idx=None):
        n = num_classes or self.num_classes
        byz = byz_mask.view(-1, *([1] * (y.dim() - 1)))
        return x, torch.where(byz, n - 1 - y, y)
