"""Clustering defense (Sattler et al., 2020).

Counterpart: ``blades_tpu/aggregators/clustering.py`` (``_matrix`` :63,
``aggregate`` :80): complete-linkage clustering into two groups over the
``[K, K]`` cosine matrix (``ops/clustering.py``), then the mean of the
larger group. ``metric='similarity'`` (the default) feeds the similarity
matrix, diagonal 1 and -1 where a row is zero, to the linkage as a
distance, as the reference does; ``metric='distance'`` uses the cosine
distance, diagonal 0 and 2 where a row is zero.

The masked form (JAX ``:84``) gives every pair with an absent row the
metric's least value (-1 similarity, 0 distance): absent rows merge into
some cluster at no linkage cost, which leaves complete linkage's maxima
unchanged, and the majority and the mean count participants only. The
streaming form (JAX ``:24-30``) is two-level: the masked form within each
chunk, then over the chunk aggregates, so each linkage is ``chunk^2`` or
``num_chunks^2``.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.clustering import complete_linkage_two_clusters, majority_cluster_mean
from blades_tpu_torch.ops.distances import pairwise_cosine_similarity


class Clustering(TwoLevelStreaming, Aggregator):
    # certification opt-outs (JAX ``clustering.py:40``): cosine features are
    # origin-anchored, and the default metric's inverted linkage breaks
    # under magnitude attacks
    audit_optouts = {
        "translation": "cosine-similarity features are origin-anchored; a "
                       "global translation changes the cluster assignment",
        "resilience": "default metric='similarity' reproduces the "
                      "reference's inverted similarity-as-distance linkage, "
                      "which breaks under magnitude attacks; "
                      "metric='distance' certifies (see cert matrix)",
    }

    def __init__(self, metric: str = "similarity"):
        if metric not in ("similarity", "distance"):
            raise ValueError(metric)
        self.metric = metric
        if metric == "distance":
            # the intended-metric variant certifies resilience; the
            # instance's set shadows the class's (JAX ``:59-60``), and the
            # certification reads the instance
            self.audit_optouts = {"translation": type(self).audit_optouts["translation"]}

    def _matrix(self, updates):
        sim = pairwise_cosine_similarity(updates)
        # a zero row has no cosine: the reference's scipy path gives NaN
        # there, mapped to -1 similarity / 2 distance
        zero = torch.linalg.vector_norm(updates, dim=-1) == 0.0
        undef = zero[:, None] | zero[None, :]
        eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
        if self.metric == "similarity":
            return torch.where(eye, 1.0, torch.where(undef, -1.0, sim))
        return torch.where(eye, 0.0, torch.where(undef, 2.0, 1.0 - sim))

    def aggregate(self, updates, state=(), **ctx):
        labels = complete_linkage_two_clusters(self._matrix(updates))
        return majority_cluster_mean(updates, labels), state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        k = updates.shape[0]
        least = -1.0 if self.metric == "similarity" else 0.0
        eye = torch.eye(k, dtype=torch.bool, device=updates.device)
        out_pair = (~mask[:, None] | ~mask[None, :]) & ~eye
        labels = complete_linkage_two_clusters(torch.where(out_pair, least, self._matrix(updates)))
        # the participants of the cluster holding more of them (a tie goes
        # to cluster 0); the zero vector when none participate
        mf = mask.to(updates.dtype)
        size1 = (mf * labels).sum()
        majority = (size1 > mf.sum() - size1).to(labels.dtype)
        sel = (labels == majority).to(updates.dtype) * mf
        return (sel @ updates) / torch.clamp_min(sel.sum(), 1.0), state
