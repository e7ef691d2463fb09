"""Sample mean. Counterpart: ``blades_tpu/aggregators/mean.py:11-52``; the
masked form is ``ops/masked.py:masked_mean``, and the streaming form (JAX
``:34-52``) is exact: a running ``(sum, count)`` carry, so chunking only
changes the order of the sum."""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.ops.masked import masked_mean


class Mean(Aggregator):
    r"""Computes the sample mean over client updates: one row reduction."""

    audit_optouts = {
        "resilience": "breakdown point 0: one unbounded byzantine row moves "
                      "the average arbitrarily far from the honest mean",
    }
    streaming_exact = True

    def aggregate(self, updates, state=(), **ctx):
        return updates.mean(dim=0), state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        return masked_mean(updates, mask), state

    def streaming_init(self, num_clients, num_chunks, chunk_size, dim, state=(), *,
                       device="cpu"):
        return {"sum": torch.zeros(dim, dtype=torch.float32, device=device),
                "count": torch.zeros((), dtype=torch.float32, device=device)}

    def streaming_update(self, sstate, chunk_updates, *, chunk_mask, chunk_index, **ctx):
        w = chunk_mask.to(chunk_updates.dtype)
        return {"sum": sstate["sum"] + (chunk_updates * w[:, None]).sum(dim=0),
                "count": sstate["count"] + w.sum()}

    def streaming_finalize(self, sstate, state=(), **ctx):
        return sstate["sum"] / torch.clamp_min(sstate["count"], 1.0), state
