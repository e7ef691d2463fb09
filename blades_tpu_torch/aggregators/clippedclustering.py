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

The masked form (JAX ``:101``) keeps the K writes a round: an absent
client's slot records the round's participant median, which leaves the
history's median where the participants put it, and a round with no
participant leaves the whole history (values, ``pos``, ``count``) as it
was. Clustering then runs in its masked form.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.aggregators.clustering import Clustering
from blades_tpu_torch.ops.masked import masked_median_1d


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
        norms = torch.linalg.vector_norm(updates, dim=1)
        new_state = self._append(state, norms.to(torch.float32), None)
        agg, _ = self._clustering.aggregate(self._clip(updates, norms, new_state))
        return agg, new_state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        norms = torch.linalg.vector_norm(updates, dim=1)
        writes = torch.where(mask, norms, masked_median_1d(norms, mask)).to(torch.float32)
        new_state = self._append(state, writes, mask.any())
        agg, _ = self._clustering._masked_aggregate(
            self._clip(updates, norms, new_state), (), mask=mask)
        return agg, new_state

    def _append(self, state, writes, gate):
        """The ring buffer with this round's K ``writes`` appended; with a
        0-d bool ``gate`` that is False, the buffer as it was."""
        dev, k, cap = writes.device, writes.shape[0], self.history_cap
        old = {n: t.to(dev) for n, t in state.items()}
        idx = (old["pos"] + torch.arange(k, device=dev)) % cap
        new = {"norms": old["norms"].index_copy(0, idx, writes), "pos": (old["pos"] + k) % cap,
               "count": torch.clamp_max(old["count"] + k, cap)}
        if gate is None:
            return new
        return {n: torch.where(gate, new[n], old[n]) for n in new}

    def _clip(self, updates, norms, state):
        """Rows whose norm passes the threshold (``tau``, or the history's
        median) scaled down to it."""
        if self.tau is not None:
            threshold = torch.full((), self.tau, dtype=updates.dtype, device=updates.device)
        else:
            threshold = masked_median(state["norms"], state["count"]).to(updates.dtype)
        coef = torch.clamp_max(threshold / (norms + 1e-6), 1.0)
        return torch.where((norms > threshold)[:, None], updates * coef[:, None], updates)
