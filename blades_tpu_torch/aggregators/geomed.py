"""Geometric median via smoothed Weiszfeld (Chen et al., 2017).

Counterpart: ``blades_tpu/aggregators/geomed.py`` (``weiszfeld`` :22, its
``while_loop`` :76; ``Geomed.aggregate`` :99 with the ``weights=`` context).
From the mean, iterate ``w_i <- max(eps, a_i / max(eps, |z - x_i|))``
(normalised), ``z <- sum_i w_i x_i`` while the weighted objective still
moves by at least ``ftol`` of itself, at most ``maxiter`` times.

With ``mask`` (the masked form, JAX ``:109``) the solve runs over the
participating rows: absent rows start at weight 0, and the ``eps`` weight
floor, which would bring them back, is masked again each iteration.

The stopping rule is the JAX package's, tested on the host: each iteration
reads one 0-d comparison from the device (one sync), so the loop stops
where the JAX ``while_loop`` stops and does no work past it. The distances
to the new iterate, which the objective needs, are kept for the next
iteration's weights instead of being computed again.

The streaming form (JAX ``Geomed`` :82-135) is two-level: the masked solve
within each chunk, then a Weiszfeld solve over the chunk medians that
starts from their participant counts as weights (``_combine_chunk_aggs``),
so unequal participation does not skew it; ``last_iterations`` records the
last solve.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming


def _dists(updates: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(updates - z, dim=1)


def weiszfeld(
    updates: torch.Tensor,
    init_weights: Optional[torch.Tensor] = None,
    maxiter: int = 100,
    eps: float = 1e-6,
    ftol: float = 1e-10,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``argmin_z sum_i a_i |z - x_i|`` over the rows of ``updates`` (the
    participating ones, with ``mask``): ``(z [D], |z - x_i| [K],
    iterations)``."""
    k = updates.shape[0]
    msk = None if mask is None else mask.to(updates.dtype)
    if init_weights is not None:
        alphas = init_weights.to(updates.device, updates.dtype)
        if msk is not None:
            alphas = alphas * msk
    elif msk is None:
        alphas = torch.full((k,), 1.0 / k, dtype=updates.dtype, device=updates.device)
    else:
        alphas = msk / torch.clamp_min(msk.sum(), 1.0)
    if msk is None:
        z = updates.mean(dim=0)
    else:
        z = (updates * msk[:, None]).sum(dim=0) / torch.clamp_min(msk.sum(), 1.0)
    d = _dists(updates, z)
    obj = (alphas * d).sum()
    prev = torch.full_like(obj, float("inf"))
    i = 0
    # the stopping rule is tested on the host, one read an iteration
    # (ROADMAP.md queue B, item 7c)  # blades: allow[SYNC001]
    while i < maxiter and bool(torch.abs(prev - obj) >= ftol * obj):
        w = torch.clamp_min(alphas / torch.clamp_min(d, eps), eps)
        if msk is not None:
            w = w * msk
        w = w / w.sum()
        z = w @ updates
        d = _dists(updates, z)
        prev, obj, alphas = obj, (w * d).sum(), w
        i += 1
    return z, d, i


class Geomed(TwoLevelStreaming, Aggregator):
    graph_unsafe_reason = ("its Weiszfeld loop tests the stopping rule on the host, one "
                           "sync an iteration (ROADMAP.md queue B, item 7c)")

    def __init__(self, maxiter: int = 100, eps: float = 1e-6, ftol: float = 1e-10):
        self.maxiter = maxiter
        self.eps = eps
        self.ftol = ftol
        #: Weiszfeld iterations of the last call (host-side record)
        self.last_iterations = 0

    def aggregate(self, updates, state=(), *, weights=None, **ctx):
        z, _, self.last_iterations = weiszfeld(
            updates, init_weights=weights, maxiter=self.maxiter, eps=self.eps,
            ftol=self.ftol,
        )
        return z, state

    def _masked_aggregate(self, updates, state, *, mask, weights=None, **ctx):
        z, _, self.last_iterations = weiszfeld(
            updates, init_weights=weights, maxiter=self.maxiter, eps=self.eps,
            ftol=self.ftol, mask=mask,
        )
        return torch.where(mask.any(), z, torch.zeros_like(z)), state

    def _combine_chunk_aggs(self, aggs, counts, state, **ctx):
        w = counts.to(aggs.dtype)
        total = w.sum()
        z, _, self.last_iterations = weiszfeld(
            aggs, init_weights=w / torch.clamp_min(total, 1.0), maxiter=self.maxiter,
            eps=self.eps, ftol=self.ftol, mask=counts > 0,
        )
        return torch.where(total > 0, z, torch.zeros_like(z)), state
