"""Complete-linkage agglomerative clustering into two groups, on the device.

Counterpart: ``blades_tpu/ops/clustering.py`` (``complete_linkage_two_clusters``
:24, ``majority_cluster_mean`` :56). The JAX package runs the K-2 merge
steps in a ``fori_loop``; here they are an eager loop whose indices stay
on the device (``argmin`` over the flattened masked matrix, then
``index_copy_`` / ``torch.where`` with tensor indices), so the loop never
waits for the device. ``torch.argmin`` returns the first index among equal
minima, as ``jnp.argmin`` does, so tied distances (ALIE's identical rows)
merge in the same order and give the same partition.
"""

from __future__ import annotations

import torch


def complete_linkage_two_clusters(dist: torch.Tensor) -> torch.Tensor:
    """``[K, K]`` symmetric distance matrix -> labels ``[K]`` in {0, 1};
    label 0 is the cluster holding point 0. Each step merges the closest
    active pair ``i < j`` into ``i`` with the complete-linkage row
    ``max(d_i, d_j)`` and retires ``j``."""
    k = dist.shape[0]
    dev = dist.device
    big = torch.full((), torch.finfo(dist.dtype).max, dtype=dist.dtype, device=dev)
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    d = torch.where(eye, big, dist)
    active = torch.ones(k, dtype=torch.bool, device=dev)
    labels = torch.arange(k, device=dev)
    for _ in range(k - 2):
        masked = torch.where(active[:, None] & active[None, :], d, big)
        flat = torch.argmin(masked)
        a, b = flat // k, flat % k
        i, j = torch.minimum(a, b).view(1), torch.maximum(a, b).view(1)
        merged = torch.maximum(d.index_select(0, i), d.index_select(0, j))  # [1, K]
        d.index_copy_(0, i, merged)
        d.index_copy_(1, i, merged.T)
        d.index_put_((i, i), big)
        active.index_fill_(0, j, False)
        labels = torch.where(labels == j, i, labels)
    return (labels != labels[0]).to(torch.int64)


def majority_cluster_mean(updates: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of the rows of the larger cluster; a tie goes to cluster 0, the
    one holding client 0."""
    k = labels.shape[0]
    size1 = labels.sum()
    majority = (size1 > k - size1).to(labels.dtype)
    mask = (labels == majority).to(updates.dtype)
    return (mask @ updates) / mask.sum()
