"""Auto-weighted geometric median (Li et al., IEEE IoT-J 2021).

Counterpart: ``blades_tpu/aggregators/autogm.py`` (``_aggregate_impl`` :52,
its outer ``while_loop`` :122 around ``weiszfeld``). The outer loop
re-solves the client weights ``alpha`` from the sorted distances through
the ``eta`` threshold search (the paper's sorted form, as the JAX package
implements it), the inner loop is a Weiszfeld solve; it stops on the
penalised objective ``sum_i a_i |z - x_i| + lamb |alpha|^2 / 2`` by the
same rule as ``geomed.weiszfeld``, tested on the host once per outer and
once per inner iteration.

The masked form (JAX ``_masked_aggregate`` :49) restricts the weight
search and every Weiszfeld solve to the participating rows: absent rows
sort past the participants and are left out of the ``eta`` prefix sums,
and their weights stay 0. ``lamb`` stays K-scaled under dropout, as in the
JAX package. The streaming form (JAX ``:25-31``) is two-level: the masked
solve within each chunk (``lamb`` from the chunk's rows), then over the
chunk aggregates; ``last_iterations`` then records the last level's solve.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.aggregators.geomed import weiszfeld


class Autogm(TwoLevelStreaming, Aggregator):
    graph_unsafe_reason = ("its outer and Weiszfeld loops test their stopping rules on the "
                           "host, one sync an iteration (ROADMAP.md queue B, item 7c)")

    def __init__(
        self,
        lamb: float = None,
        maxiter: int = 100,
        eps: float = 1e-6,
        ftol: float = 1e-10,
        inner_maxiter: int = 100,
    ):
        self.lamb = lamb
        self.maxiter = maxiter
        self.eps = eps
        self.ftol = ftol
        self.inner_maxiter = inner_maxiter
        #: (outer iterations, inner Weiszfeld iterations summed) of the last
        #: call (host-side record)
        self.last_iterations = (0, 0)

    def aggregate(self, updates, state=(), **ctx):
        return self._aggregate_impl(updates, None), state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        z = self._aggregate_impl(updates, mask)
        return torch.where(mask.any(), z, torch.zeros_like(z)), state

    def _aggregate_impl(self, updates, mask):
        k = updates.shape[0]
        lamb = float(k) if self.lamb is None else self.lamb
        msk = None if mask is None else mask.to(updates.dtype)
        inner = 0

        def solve(alpha):
            nonlocal inner
            z, d, it = weiszfeld(updates, init_weights=alpha, maxiter=self.inner_maxiter,
                                 eps=self.eps, ftol=self.ftol, mask=mask)
            inner += it
            return z, d, (alpha * d).sum() + lamb * (alpha**2).sum() / 2.0

        if msk is None:
            alpha = torch.full((k,), 1.0 / k, dtype=updates.dtype, device=updates.device)
        else:
            alpha = msk / torch.clamp_min(msk.sum(), 1.0)
        z, d, obj = solve(alpha)
        prev = torch.full_like(obj, float("inf"))
        slots = torch.arange(k, device=updates.device)
        p1 = (slots + 1).to(updates.dtype)
        i = 0
        while i < self.maxiter and bool(torch.abs(prev - obj) >= self.ftol * obj):
            if msk is None:
                d_sorted = summable = torch.sort(d).values
            else:
                # absent rows sort last; their +inf fails the eta test below
                d_sorted = torch.sort(torch.where(mask, d, float("inf"))).values
                summable = torch.where(slots < mask.sum(), d_sorted, 0.0)
            # eta_p = (sum of the p+1 smallest distances + lamb) / (p + 1);
            # the optimum is the last eta of the longest prefix with
            # eta_p >= d_(p)
            etas = (torch.cumsum(summable, 0) + lamb) / p1
            count = torch.cumprod((etas - d_sorted >= 0).to(torch.int32), 0).sum()
            last = etas.index_select(0, torch.clamp_min(count - 1, 0).view(1))[0]
            eta_opt = torch.where(count > 0, last, 1e16)
            alpha = torch.clamp_min(eta_opt - d, 0.0) / lamb
            if msk is not None:
                alpha = alpha * msk
            prev = obj
            z, d, obj = solve(alpha)
            i += 1
        self.last_iterations = (i, inner)
        return z
