"""Divide-and-Conquer (Shejwalkar & Houmansadr, NDSS 2021).

Counterpart: ``blades_tpu/aggregators/dnc.py`` (``_top_singular_dir`` :21,
``_aggregate_impl`` :67). Each of ``num_iters`` iterations takes
``sub_dim`` random coordinates, centres that submatrix, finds its top right
singular vector by ``power_iters`` steps of power iteration, scores every
client by its squared projection and drops the ``filter_frac * f`` highest
scores; the result is the mean of the clients no iteration dropped.

The random coordinates and the power iteration's start vectors come from
:func:`draw_subspaces` on the round's ``AGG`` generator, where the JAX
package draws ``jax.random.choice`` and ``jax.random.normal``; torch cannot
reproduce those bits, so tests hand both packages the same draws.

In the masked form (JAX ``_aggregate_impl`` :67 with a mask) the principal
direction and the scores are computed over the participants (absent rows
are 0 in the centred submatrix), absent rows score ``-inf``, so the
``filter_frac * f`` removals still take the largest participant scores,
and only participants can survive.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from blades_tpu_torch.aggregators.base import Aggregator


def draw_subspaces(
    generator: Optional[torch.Generator], num_iters: int, dim: int, sub_dim: int, device
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per iteration, ``sub_dim`` distinct coordinates of ``range(dim)`` and a
    float32 standard-normal start vector of ``sub_dim``, drawn in that order
    on the generator's device (a fresh default generator when None) and
    moved to ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    g_dev = generator.device
    out = []
    for _ in range(num_iters):
        idx = torch.randperm(dim, generator=generator, device=g_dev)[:sub_dim]
        v0 = torch.randn(sub_dim, generator=generator, device=g_dev)
        out.append((idx.to(device), v0.to(device)))
    return out


def _top_singular_dir(x: torch.Tensor, iters: int, v0: torch.Tensor) -> torch.Tensor:
    """Top right singular vector of ``x [K, d]``: power iteration on
    ``x^T x`` from ``v0``."""
    v = v0 / torch.sqrt((v0 * v0).sum())
    for _ in range(iters):
        v = x.T @ (x @ v)
        v = v / torch.sqrt(torch.clamp_min((v * v).sum(), 1e-24))
    return v


class Dnc(Aggregator):
    # no streaming form (JAX ``dnc.py:40-45``)
    streaming_optouts = {
        "streaming": "outlier scores project every row onto a population-"
                     "level principal direction known only after the full "
                     "pass; each of num_iters rounds needs a fresh "
                     "two-pass sweep",
    }

    def __init__(
        self,
        num_byzantine: int = 5,
        sub_dim: int = 10000,
        num_iters: int = 5,
        filter_frac: float = 1.0,
        power_iters: int = 10,
    ):
        self.f = num_byzantine
        self.sub_dim = sub_dim
        self.num_iters = num_iters
        self.filter_frac = filter_frac
        self.power_iters = power_iters

    def aggregate(self, updates, state=(), *, generator=None, **ctx):
        return self._aggregate_impl(updates, generator, None), state

    def _masked_aggregate(self, updates, state, *, mask, generator=None, **ctx):
        return self._aggregate_impl(updates, generator, mask), state

    def _aggregate_impl(self, updates, generator, mask):
        k, d = updates.shape
        sub_dim = min(self.sub_dim, d)
        n_remove = min(int(self.filter_frac * self.f), k - 1)
        if mask is None:
            good = torch.ones(k, dtype=torch.bool, device=updates.device)
        else:
            good, m = mask, mask.to(updates.dtype)
        for idx, v0 in draw_subspaces(generator, self.num_iters, d, sub_dim, updates.device):
            sub = updates.index_select(1, idx)
            if mask is None:
                centered = sub - sub.mean(dim=0)
            else:
                mean = (sub * m[:, None]).sum(dim=0) / torch.clamp_min(m.sum(), 1.0)
                centered = torch.where(mask[:, None], sub - mean, 0.0)
            v = _top_singular_dir(centered, self.power_iters, v0.to(updates.dtype))
            scores = (centered @ v) ** 2
            if mask is not None:
                scores = torch.where(mask, scores, float("-inf"))
            # keep everyone except the n_remove largest scores
            cutoff = torch.sort(scores).values[k - n_remove - 1]
            good = good & (scores <= cutoff)
        w = good.to(updates.dtype)
        return (w @ updates) / torch.clamp_min(w.sum(), 1.0)

    def __repr__(self):
        return f"DnC (f={self.f}, iters={self.num_iters})"
