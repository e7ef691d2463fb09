"""ALIE ("A Little Is Enough") omniscient attack.

Counterpart: ``blades_tpu/attackers/alie.py:22-63``:
``z_max = norm.ppf((n - f - s) / (n - f))`` with ``s = floor(n/2 + 1) - f``,
resolved on the host with scipy; each byzantine row becomes
``mu - z_max * std`` over the honest rows' per-coordinate moments.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from scipy.stats import norm

from blades_tpu_torch.attackers.base import Attack, honest_stats


class Alie(Attack):
    # omniscient: byzantine rows are built from honest-population moments
    update_locality = "population"

    def __init__(
        self,
        num_clients: Optional[int] = None,
        num_byzantine: Optional[int] = None,
        z: Optional[float] = None,
    ):
        self.num_clients = num_clients
        self.num_byzantine = num_byzantine
        self.z = z

    @property
    def graph_unsafe_reason(self) -> Optional[str]:
        """Without ``num_byzantine``, ``on_updates`` counts the byzantine
        rows on the host, a sync a round; the Simulator fills it in."""
        if self.num_byzantine is None:
            return ("without num_byzantine it counts the byzantine rows on the host "
                    "(int(byz_mask.sum())) every round")
        return None

    def _z_max(self, n: int, f: int) -> float:
        if self.z is not None:
            return float(self.z)
        s = math.floor(n / 2 + 1) - f
        cdf_value = (n - f - s) / (n - f)
        # f beyond the supported-majority regime pushes the cdf outside
        # (0, 1), where ppf is NaN; clamp so the attack stays finite
        cdf_value = min(max(cdf_value, 1e-9), 1.0 - 1e-9)
        return float(norm.ppf(cdf_value))

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        n = self.num_clients if self.num_clients is not None else updates.shape[0]
        f = (
            self.num_byzantine
            if self.num_byzantine is not None
            else int(byz_mask.sum())
        )
        z_max = self._z_max(int(n), int(f))
        mu, std, _ = honest_stats(updates, byz_mask)
        malicious = mu - z_max * std
        return torch.where(byz_mask[:, None], malicious[None, :], updates), state

    def on_updates_batched(self, updates, byz_mask, generators, states):
        """ALIE draws nothing: one ``torch.func.vmap`` of :meth:`on_updates`
        over the ``[S, K, D]`` stack."""
        return torch.func.vmap(lambda u: self.on_updates(u, byz_mask)[0])(updates), list(states)
