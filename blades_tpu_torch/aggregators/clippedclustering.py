"""Clipped clustering (Li et al., TechRxiv 2022).

Counterpart: ``blades_tpu/aggregators/clippedclustering.py:78``: append the
round's K update norms to a history, clip every row whose norm exceeds the
history's median (or a fixed ``tau``) down to it with the reference's
``min(1, tau / (|u| + 1e-6))``, then cluster on cosine distance
(``Clustering(metric='distance')``) and average the larger group.

The history is the JAX package's fixed ring buffer, carried as the
aggregator's state: ``history_cap`` float32 norms, the write position
``pos`` and the live count ``count`` (0-d int32). Its median is the
midpoint of the two central live entries. All of it stays on the device.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.aggregators.clustering import Clustering


def masked_median(norms: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median of the first ``n`` entries (0-d tensor ``n``; numpy's
    midpoint of the two central values for even n)."""
    cap = norms.shape[0]
    filled = torch.arange(cap, device=norms.device) < n
    s = torch.sort(torch.where(filled, norms, float("inf"))).values
    lo = s.index_select(0, torch.clamp_min((n - 1) // 2, 0).view(1))[0]
    hi = s.index_select(0, torch.clamp_min(n // 2, 0).view(1))[0]
    return (lo + hi) / 2.0


class Clippedclustering(Aggregator):
    stateful = True

    def __init__(self, tau: float = None, history_cap: int = 65536):
        self.tau = tau
        self.history_cap = history_cap
        self._clustering = Clustering(metric="distance")

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return {
            "norms": torch.zeros(self.history_cap, dtype=torch.float32),
            "pos": torch.zeros((), dtype=torch.int32),
            "count": torch.zeros((), dtype=torch.int32),
        }

    def aggregate(self, updates, state, **ctx):
        k, dev = updates.shape[0], updates.device
        norms = torch.linalg.vector_norm(updates, dim=1)
        cap = self.history_cap
        pos, count = state["pos"].to(dev), state["count"].to(dev)
        idx = (pos + torch.arange(k, device=dev)) % cap
        hist = state["norms"].to(dev).index_copy(0, idx, norms.to(torch.float32))
        new_state = {"norms": hist, "pos": (pos + k) % cap,
                     "count": torch.clamp_max(count + k, cap)}
        if self.tau is not None:
            threshold = torch.full((), self.tau, dtype=updates.dtype, device=dev)
        else:
            threshold = masked_median(hist, new_state["count"]).to(updates.dtype)
        coef = torch.clamp_max(threshold / (norms + 1e-6), 1.0)
        clipped = torch.where((norms > threshold)[:, None], updates * coef[:, None], updates)
        agg, _ = self._clustering.aggregate(clipped)
        return agg, new_state
