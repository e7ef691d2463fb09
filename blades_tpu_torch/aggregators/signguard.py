"""SignGuard (Xu et al., ICDCS 2022): norm and sign-statistics filtering.

Counterpart: ``blades_tpu/aggregators/signguard.py`` (``_aggregate_impl``
:54). Two filters: keep the clients whose L2 norm lies in
``[lower, upper] * median norm``, and, after complete-linkage clustering
into two groups on each client's (positive, zero, negative) sign shares
(``ops/clustering.py``), those of the larger group. The aggregate is the
mean of the clients that pass both, each scaled down to the median norm.

The sign shares are counts of ``u > 0``, ``u == 0`` and ``u < 0`` times the
float32 reciprocal of D, which is what ``mean(sign(u) > 0)`` and its two
siblings give in the JAX package, without the ``[K, D]`` sign matrix; the clip is folded into the weights of one
matrix-vector product. In the masked form the median norm and the majority
are the participants', absent rows sit at distance 0 from everyone in the
linkage (neutral for complete linkage, as in ``Clustering``), and the mean
weights participants only. The streaming form (JAX ``:25-30``) is
two-level: both filters within each chunk (its own median norm), then over
the chunk aggregates.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.clustering import complete_linkage_two_clusters
from blades_tpu_torch.ops.masked import masked_median_1d


class Signguard(TwoLevelStreaming, Aggregator):
    audit_optouts = {
        "translation": "norm-band and gradient-sign statistics are "
                       "origin-anchored; a global translation changes which "
                       "clients the filters keep",
    }

    def __init__(self, lower: float = 0.1, upper: float = 3.0):
        self.lower = lower
        self.upper = upper

    def aggregate(self, updates, state=(), **ctx):
        return self._aggregate_impl(updates, None), state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        return self._aggregate_impl(updates, mask), state

    def _aggregate_impl(self, updates, mask):
        k, d = updates.shape
        norms = torch.sqrt(torch.clamp_min((updates * updates).sum(dim=1), 1e-24))
        if mask is None:
            s = torch.sort(norms).values
            med = (s[(k - 1) // 2] + s[k // 2]) / 2.0
        else:
            med = masked_median_1d(norms, mask)
        norm_ok = (norms >= self.lower * med) & (norms <= self.upper * med)

        # the JAX package's mean of a sign mask is its count times the f32
        # reciprocal of D, which can be an ulp off count / D; shares that tie
        # in exact arithmetic tie in the linkage, so take the same rounding
        feats = torch.stack([(updates > 0).sum(dim=1), (updates == 0).sum(dim=1),
                             (updates < 0).sum(dim=1)], dim=1).to(updates.dtype) * (1.0 / d)
        diff = feats[:, None, :] - feats[None, :, :]
        dist = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=-1), 0.0))
        if mask is not None:
            eye = torch.eye(k, dtype=torch.bool, device=updates.device)
            dist = torch.where((~mask[:, None] | ~mask[None, :]) & ~eye, 0.0, dist)
        labels = complete_linkage_two_clusters(dist)
        mi = torch.ones_like(labels) if mask is None else mask.to(labels.dtype)
        size1 = (mi * labels).sum()
        majority = (size1 > mi.sum() - size1).to(labels.dtype)

        keep = (norm_ok & (labels == majority)).to(updates.dtype)
        if mask is not None:
            keep = keep * mask.to(updates.dtype)
        clip = torch.clamp_max(med / norms, 1.0)
        return ((keep * clip) @ updates) / torch.clamp_min(keep.sum(), 1.0)
