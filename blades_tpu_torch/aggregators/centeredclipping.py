"""Centered clipping (Karimireddy et al., ICML 2021).

Counterpart: ``blades_tpu/aggregators/centeredclipping.py:44``: a momentum
center ``v`` carried across rounds as the aggregator's state (a ``[D]``
float32 vector), and ``n_iter`` inner steps
``v <- v + mean_i clip(u_i - v, tau)`` with ``clip(x) = x * min(1, tau/|x|)``.
The masked form (JAX ``:58``) takes that mean over the participants only,
so an absent client neither pulls the center nor damps it, and a round
with none leaves it where it was.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator


class Centeredclipping(Aggregator):
    stateful = True

    def __init__(self, tau: float = 10.0, n_iter: int = 5):
        self.tau = tau
        self.n_iter = n_iter

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return torch.zeros(dim, dtype=torch.float32)

    def aggregate(self, updates, state, **ctx):
        momentum = state.to(updates.device, updates.dtype)
        for _ in range(self.n_iter):
            v = updates - momentum
            momentum = momentum + (v * self._scale(v)[:, None]).mean(dim=0)
        return momentum, momentum

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        momentum = state.to(updates.device, updates.dtype)
        m = mask.to(updates.dtype)
        denom = torch.clamp_min(m.sum(), 1.0)
        for _ in range(self.n_iter):
            v = updates - momentum
            # the 0/1 mask folded into the clip scale: exact, one pass fewer
            momentum = momentum + (v * (self._scale(v) * m)[:, None]).sum(dim=0) / denom
        return momentum, momentum

    def _scale(self, v):
        """Each row's clip factor ``min(1, tau / |v_i|)``."""
        norms = torch.sqrt(torch.clamp_min((v * v).sum(dim=1), 1e-24))
        return torch.clamp_max(self.tau / norms, 1.0)

    def __repr__(self):
        return f"Clipping (tau={self.tau}, n_iter={self.n_iter})"
