"""Krum / Multi-Krum (Blanchard et al., NeurIPS 2017).

Counterpart: ``blades_tpu/aggregators/krum.py:25-170`` (``scores`` :45,
``_select`` :59, ``aggregate`` :64). Each client scores the sum of its
``K - f - 2`` smallest squared distances (``distance_power=4`` squares them
again, the reference's accidental behaviour); the ``m`` lowest scores are
averaged. The distance matrix is one GEMM (``ops/distances.py``), and the
ranking is a stable ``argsort``, as ``jnp.argsort`` is: equal scores keep
the lower client index.

The masked form (``_masked_scores`` :80, ``_masked_aggregate`` :110) scores
participants against participants only: pairs with an absent row sit at
``+inf``, each participant sums its ``max(n - f - 2, 1)`` nearest finite
distances, and absent rows score ``+inf``, so selection never picks one.
With fewer participants than ``m`` only the first ``m_eff = min(m, n)``
selected rows are weighted, and the mean is rescaled by ``m / m_eff``; ``n``
and ``m_eff`` stay device tensors.

The streaming form (JAX ``Krum`` :25-31, ``_level_clone`` :124-146) is
two-level: Krum within each chunk, then over the chunk winners, each level
with ``f`` and ``m`` shrunk to fit its rows (``2f + 2 <= rows``, ``m <=
rows``; a chunk's rows include the final chunk's padding).
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.distances import pairwise_sq_euclidean


class Krum(TwoLevelStreaming, Aggregator):
    def __init__(
        self,
        num_clients: int = None,
        num_byzantine: int = 5,
        num_selected: int = 1,
        distance_power: int = 2,
    ):
        # num_clients is accepted for reference ctor parity; K comes from
        # the update matrix
        self.f = num_byzantine
        self.m = num_selected
        self.distance_power = distance_power

    def scores(self, updates: torch.Tensor) -> torch.Tensor:
        k = updates.shape[0]
        if 2 * self.f + 2 > k:
            raise ValueError(f"Too many Byzantine workers: 2*{self.f}+2 > {k}")
        d2 = pairwise_sq_euclidean(updates)
        if self.distance_power == 4:
            d2 = d2 * d2
        # a client is not its own neighbour: the diagonal sorts last
        eye = torch.eye(k, dtype=torch.bool, device=updates.device)
        d2 = torch.where(eye, float("inf"), d2)
        return torch.sort(d2, dim=1).values[:, : k - self.f - 2].sum(dim=1)

    def _select(self, updates):
        """``(scores [K], selected [m])``."""
        scores = self.scores(updates)
        return scores, torch.argsort(scores, stable=True)[: self.m]

    def aggregate(self, updates, state=(), **ctx):
        _, top_m = self._select(updates)
        # the mean of the m selected rows (the Multi-Krum paper; the
        # reference only runs m=1, where sum and mean agree)
        return updates.index_select(0, top_m).mean(dim=0), state

    def _masked_scores(self, updates, mask):
        """``(scores [K], n)``: Krum scores over the participating subset,
        absent rows at ``+inf``; ``n`` the participant count (0-d)."""
        k = updates.shape[0]
        if 2 * self.f + 2 > k:
            raise ValueError(f"Too many Byzantine workers: 2*{self.f}+2 > {k}")
        n = mask.to(torch.int32).sum(dtype=torch.int32)
        d2 = pairwise_sq_euclidean(updates)
        if self.distance_power == 4:
            d2 = d2 * d2
        eye = torch.eye(k, dtype=torch.bool, device=updates.device)
        pair_ok = mask[:, None] & mask[None, :] & ~eye
        s = torch.sort(torch.where(pair_ok, d2, float("inf")), dim=1).values
        nn = torch.clamp_min(n - self.f - 2, 1)
        # the +inf sentinels leave the sum as well as the ranks past nn, so a
        # participant with fewer than nn real neighbours keeps a finite score
        # below every absent row's
        keep = (torch.arange(k, device=updates.device)[None, :] < nn) & torch.isfinite(s)
        scores = torch.where(keep, s, 0.0).sum(dim=1)
        return torch.where(mask, scores, float("inf")), n

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        scores, n = self._masked_scores(updates, mask)
        top_m = torch.argsort(scores, stable=True)[: self.m]
        m_eff = torch.clamp(torch.clamp_min(n, 1), max=self.m)
        w = (torch.arange(top_m.numel(), device=updates.device) < m_eff).to(updates.dtype)
        sel = updates.index_select(0, top_m) * w[:, None]
        return sel.mean(dim=0) * (self.m / m_eff.to(updates.dtype)), state

    def _level_clone(self, k: int) -> "Krum":
        """This Krum with ``f`` and ``m`` shrunk to fit a ``k``-row level."""
        f = min(self.f, max((k - 2) // 2, 0))
        m = min(self.m, k)
        if (f, m) == (self.f, self.m):
            return self
        return Krum(num_byzantine=f, num_selected=m, distance_power=self.distance_power)

    def _chunk_aggregate(self, slab, *, chunk_mask, **ctx):
        agg, _ = self._level_clone(slab.shape[0])._masked_aggregate(slab, (), mask=chunk_mask)
        return agg

    def _combine_chunk_aggs(self, aggs, counts, state, **ctx):
        agg, _ = self._level_clone(aggs.shape[0])._masked_aggregate(aggs, (), mask=counts > 0)
        return torch.where(counts.sum() > 0, agg, torch.zeros_like(agg)), state

    def diagnostics(self, updates, state=(), **ctx):
        """``scores [K]`` and the ``m`` ``selected`` client indices (int32),
        from the same ``_select`` call as :meth:`aggregate` (JAX
        ``:148-154``). On the masked path they are the dense selection over
        the sanitized matrix, as in the JAX package."""
        scores, top_m = self._select(updates)
        return {"scores": scores, "selected": top_m.to(torch.int32)}

    def __repr__(self):
        return f"Krum (m={self.m})"


class Multikrum(Krum):
    """Multi-Krum: select the m best-scoring clients (m > 1)."""

    def __init__(
        self,
        num_clients: int = None,
        num_byzantine: int = 5,
        num_selected: int = 5,
        distance_power: int = 2,
    ):
        super().__init__(num_clients, num_byzantine, num_selected, distance_power)
