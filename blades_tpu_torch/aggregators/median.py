"""Coordinate-wise median (Yin et al., 2018).

Counterpart: ``blades_tpu/aggregators/median.py:23`` (``jnp.median``: the
midpoint of the two central values for even K). ``torch.median`` returns
the lower of the two, and ``torch.quantile`` refuses inputs above 2^24
elements (CCT-2's ``[1000, 283723]`` matrix has 2.8e8), so this sorts
along the client axis and takes ``(s[(K-1)//2] + s[K//2]) * 0.5``, as
``jnp.quantile(method='midpoint')`` does. ``torch.sort`` puts NaN last,
so a column holding one is NaN where its last sorted value is, as
``jnp.median`` gives (:func:`midpoint_median`, which ByzantineSGD and
SignGuard share). The sort's values and int64
indices take 3x the matrix's bytes on top of it. The masked form
(JAX ``:26``) is the sentinel sort of ``ops/masked.py:masked_median``; the
streaming form (JAX ``:17-21``) is the two-level median of chunk medians.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.masked import masked_median


def midpoint_median(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.median(x, axis=dim)``: the midpoint of the two central values
    along ``dim``; NaN where the slice holds a NaN (sorted last)."""
    k = x.shape[dim]
    s = torch.sort(x, dim=dim).values
    last, lo, hi = (s.select(dim, i) for i in (k - 1, (k - 1) // 2, k // 2))
    return torch.where(torch.isnan(last), last, (lo + hi) * 0.5)


class Median(TwoLevelStreaming, Aggregator):
    def aggregate(self, updates, state=(), **ctx):
        return midpoint_median(updates), state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        return masked_median(updates, mask), state

    def aggregate_masked_batched(self, updates, states, *, masks=None, ctxs,
                                 diagnostics=False):
        """Unmasked: one sort of the ``[S, K, D]`` stack along the clients."""
        if masks is not None:
            return super().aggregate_masked_batched(updates, states, masks=masks, ctxs=ctxs,
                                                    diagnostics=diagnostics)
        return self._dense_batched(midpoint_median(updates, dim=1), updates, states, ctxs,
                                   diagnostics)
