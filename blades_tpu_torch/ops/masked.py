"""Masked (participation-aware) reductions over the ``[K, D]`` update matrix.

Counterpart: ``blades_tpu/ops/masked.py:27-83`` (``participant_count``,
``masked_mean``, ``masked_median``, ``masked_median_1d``,
``masked_trimmed_mean``). Each reduction takes a boolean ``[K]``
participation mask and computes its statistic over the participating rows
only, with fixed shapes: masked-out rows are sentineled to ``+inf`` so they
sort past every participant, and the participant count ``n`` stays a 0-d
device tensor. Every index that depends on ``n`` is a tensor index
(``index_select``), so no reduction here waits for the device.

The masked trimmed mean takes the JAX package's survivors: per column, the
participants ranked ``b_eff <= rank < n - b_eff`` by a stable sort of the
sentinel matrix, ties (and the ``+inf`` sentinels against real ``+inf``
participants) broken by row index, as JAX's stable argsort breaks them.
A NaN participant sorts past the sentinels, so with more NaN participants
than ``b_eff`` a kept slot holds a masked-out row; the JAX package then
adds that row, which ``Aggregator._sanitize`` has set to 0, and so does
this one: the sort's indices pick out such slots (the ``[K]`` mask gathered
through them), and they add 0. Where the JAX package ranks with two
argsorts and sums in row order, this sums the sorted values, so the two
agree up to the order of the sum.
"""

from __future__ import annotations

import torch


def participant_count(mask: torch.Tensor) -> torch.Tensor:
    """Number of participating clients, a 0-d int32 tensor."""
    return mask.to(torch.int32).sum(dtype=torch.int32)


def masked_mean(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row mean over the participating rows; the zero vector when none
    participate."""
    m = mask.to(updates.dtype)
    return (updates * m[:, None]).sum(dim=0) / torch.clamp_min(m.sum(), 1.0)


def _slot(s: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d integer tensor) of ``s``."""
    return s.index_select(0, i.view(1).to(torch.int64))[0]


def masked_median(updates: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the participating rows (the midpoint of
    the two central values for an even count), by sentinel sort: the first
    ``n`` order statistics of each column are the participants'. The zero
    vector when none participate."""
    n = participant_count(mask)
    s = torch.sort(torch.where(mask[:, None], updates, float("inf")), dim=0).values
    lo = _slot(s, torch.clamp_min((n - 1) // 2, 0))
    hi = _slot(s, torch.clamp_min(n // 2, 0))
    mid = (lo + hi) / 2.0
    return torch.where(n > 0, mid, torch.zeros_like(mid))


def masked_median_1d(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of the participating entries of a ``[K]`` vector, 0-d."""
    return masked_median(values[:, None], mask)[0]


def masked_trimmed_mean(updates: torch.Tensor, mask: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the participating rows.

    Per column, the ``b_eff`` smallest and largest of the ``n`` participants
    are dropped and the rest averaged. ``b`` (already shrunk against the
    full K) is clamped to the participant count, ``b_eff = min(b,
    max((n - 1) // 2, 0))``, so that ``n - 2 b_eff >= 1`` whenever ``n >= 1``:
    under heavy dropout the trim narrows toward the masked median. The
    survivors are the sorted slots ``b_eff <= j < n - b_eff`` of the
    stable sentinel sort; a kept slot that holds a masked-out row adds 0,
    that row's value once sanitized.
    """
    k = updates.shape[0]
    n = participant_count(mask)
    b_eff = torch.clamp(torch.clamp_min((n - 1) // 2, 0), max=int(b))
    s, idx = torch.sort(torch.where(mask[:, None], updates, float("inf")), dim=0, stable=True)
    absent = ~mask[idx]
    del idx
    slots = torch.arange(k, device=updates.device)
    drop = (slots < b_eff) | (slots >= n - b_eff)
    denom = torch.clamp_min(n - 2 * b_eff, 1).to(updates.dtype)
    return s.masked_fill_(absent | drop[:, None], 0.0).sum(dim=0) / denom
