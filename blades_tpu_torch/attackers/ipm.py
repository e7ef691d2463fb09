"""IPM (Inner Product Manipulation) omniscient attack.

Counterpart: ``blades_tpu/attackers/ipm.py:15-25``: every byzantine row
becomes ``-epsilon * mean(honest updates)``, one masked reduction and a
``torch.where`` on the update matrix.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.attackers.base import Attack, honest_stats


class Ipm(Attack):
    # omniscient: byzantine rows are built from the honest-population mean
    update_locality = "population"

    def __init__(self, epsilon: float = 0.5):
        self.epsilon = float(epsilon)

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        mu, _, _ = honest_stats(updates, byz_mask)
        return torch.where(byz_mask[:, None], -self.epsilon * mu[None, :], updates), state
