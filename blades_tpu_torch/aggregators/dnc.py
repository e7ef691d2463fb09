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
        k, d = updates.shape
        sub_dim = min(self.sub_dim, d)
        n_remove = min(int(self.filter_frac * self.f), k - 1)
        good = torch.ones(k, dtype=torch.bool, device=updates.device)
        for idx, v0 in draw_subspaces(generator, self.num_iters, d, sub_dim, updates.device):
            sub = updates.index_select(1, idx)
            centered = sub - sub.mean(dim=0)
            v = _top_singular_dir(centered, self.power_iters, v0.to(updates.dtype))
            scores = (centered @ v) ** 2
            # keep everyone except the n_remove largest scores
            cutoff = torch.sort(scores).values[k - n_remove - 1]
            good = good & (scores <= cutoff)
        w = good.to(updates.dtype)
        return (w @ updates) / torch.clamp_min(w.sum(), 1.0), state

    def __repr__(self):
        return f"DnC (f={self.f}, iters={self.num_iters})"
