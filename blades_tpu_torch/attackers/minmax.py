"""Min-Max / Min-Sum AGR-agnostic attacks (Shejwalkar & Houmansadr, NDSS'21).

Counterpart: ``blades_tpu/attackers/minmax.py:29-71``. Each byzantine row
becomes ``mu - gamma * std`` over the honest rows, with ``gamma`` the
largest scale that keeps the malicious row inside the honest rows'
pairwise-distance envelope:

- minmax: its largest squared distance to an honest row is at most the
  largest squared distance between two honest rows;
- minsum: the sum of its squared distances to the honest rows is at most
  the largest such sum of one honest row.

``gamma`` comes from a fixed 20-step bisection from 10, as the JAX
package's ``fori_loop`` does. It stays on the device: each step is a
``torch.where`` on a 0-d comparison, with no host read.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.attackers.base import Attack, honest_stats
from blades_tpu_torch.ops.distances import pairwise_sq_euclidean


class _GammaScaled(Attack):
    # omniscient: the gamma search spans the full honest population
    update_locality = "population"
    n_bisect: int = 20
    gamma_init: float = 10.0

    def _feasible(self, d_honest: torch.Tensor, sq: torch.Tensor) -> torch.Tensor:
        """0-d bool: the malicious row's squared distances to each row,
        zeroed off the honest rows, against the honest pairwise matrix."""
        raise NotImplementedError

    def gamma(self, updates, byz_mask):
        """``(gamma, mu, dev)``: the bisected 0-d scale and the row it scales,
        ``mu + gamma * dev`` with ``dev = -std``."""
        mu, std, _ = honest_stats(updates, byz_mask)
        dev = -std  # the paper's "std" perturbation
        honest_w = (~byz_mask).to(updates.dtype)
        sq = pairwise_sq_euclidean(updates) * (honest_w[:, None] * honest_w[None, :])
        gamma = torch.full((), self.gamma_init, dtype=updates.dtype, device=updates.device)
        step = gamma / 2.0
        for _ in range(self.n_bisect):
            d = ((updates - (mu + gamma * dev)[None, :]) ** 2).sum(dim=1) * honest_w
            gamma = torch.where(self._feasible(d, sq), gamma + step, gamma - step)
            step = step / 2.0
        return gamma, mu, dev

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        gamma, mu, dev = self.gamma(updates, byz_mask)
        malicious = mu + gamma * dev
        return torch.where(byz_mask[:, None], malicious[None, :], updates), state


class Minmax(_GammaScaled):
    def _feasible(self, d_honest, sq):
        return d_honest.max() <= sq.max()


class Minsum(_GammaScaled):
    def _feasible(self, d_honest, sq):
        return d_honest.sum() <= sq.sum(dim=1).max()
