"""Pairwise distances over the ``[K, D]`` update matrix, one matmul each.

Counterpart: ``blades_tpu/ops/distances.py`` (``pairwise_sq_euclidean``
:15, ``pairwise_cosine_similarity`` :27). Stock torch ops: the JAX package
leaves both to XLA, and here the Gram matrix is one cuBLAS GEMM on the card.
"""

from __future__ import annotations

import torch


def pairwise_sq_euclidean(x: torch.Tensor) -> torch.Tensor:
    """``[K, D] -> [K, K]`` squared Euclidean distances from
    ``|a-b|^2 = |a|^2 + |b|^2 - 2 a.b``, with the tiny negatives that
    cancellation leaves clamped to 0. The upper triangle is mirrored onto
    the lower one: a GEMM need not give ``a.b`` and ``b.a`` the same
    rounding, and a Krum score that ties in exact arithmetic (two rows each
    other's nearest neighbour) must tie in floating point too, so that the
    stable ranking keeps the lower index, as the JAX package's does."""
    sq = (x * x).sum(dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d2 = torch.triu(d2) + torch.triu(d2, diagonal=1).T
    return torch.clamp_min(d2, 0.0)


def pairwise_cosine_similarity(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``[K, D] -> [K, K]`` cosine similarities from one normalized matmul,
    clipped to ``[-1, 1]``; a zero row's norm is clamped to ``eps``."""
    norms = torch.sqrt((x * x).sum(dim=-1))
    xn = x / torch.clamp_min(norms, eps)[:, None]
    return torch.clamp(xn @ xn.T, -1.0, 1.0)
