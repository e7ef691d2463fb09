"""Sample mean. Counterpart: ``blades_tpu/aggregators/mean.py:11-32``; the
masked form is ``ops/masked.py:masked_mean``."""

from __future__ import annotations

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
