"""Coordinate-wise median (Yin et al., 2018).

Counterpart: ``blades_tpu/aggregators/median.py:23`` (``jnp.median``: the
midpoint of the two central values for even K). ``torch.median`` returns
the lower of the two, and ``torch.quantile`` refuses inputs above 2^24
elements (CCT-2's ``[1000, 283723]`` matrix has 2.8e8), so this sorts
along the client axis and takes ``(s[(K-1)//2] + s[K//2]) * 0.5``, as
``jnp.quantile(method='midpoint')`` does. The sort's values and int64
indices take 3x the matrix's bytes on top of it. The masked form
(JAX ``:26``) is the sentinel sort of ``ops/masked.py:masked_median``; the
streaming form (JAX ``:17-21``) is the two-level median of chunk medians.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.masked import masked_median


class Median(TwoLevelStreaming, Aggregator):
    def aggregate(self, updates, state=(), **ctx):
        k = updates.shape[0]
        s = torch.sort(updates, dim=0).values
        return (s[(k - 1) // 2] + s[k // 2]) * 0.5, state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        return masked_median(updates, mask), state
