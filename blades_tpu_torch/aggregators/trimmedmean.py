"""Coordinate-wise trimmed mean (Yin et al., 2018).

Counterpart: ``blades_tpu/aggregators/trimmedmean.py:20-40``: drop the b
largest and b smallest values per coordinate and average the rest, with b
shrunk until ``K - 2b > 0``. On a CUDA tensor the selection runs in the
Hopper kernel behind ``ops/trimmed.py``. The masked form (JAX ``:42-47``)
is ``ops/masked.py:masked_trimmed_mean``, stock torch ops: under partial
participation the kernel does not run, as the JAX package leaves its
masked trim to XLA. The streaming form (JAX ``:20-26``) is two-level
(``TwoLevelStreaming``): the masked trim within each chunk, with b shrunk
against the chunk's rows (padding included, as in the JAX package), then
again across the chunk aggregates; the kernel does not run there either.
The trim-mask ``diagnostics`` come with the forensics of ``ROADMAP.md``
queue A, slice 10.
"""

from __future__ import annotations

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.masked import masked_trimmed_mean
from blades_tpu_torch.ops.trimmed import trimmed_mean


class Trimmedmean(TwoLevelStreaming, Aggregator):
    def __init__(self, num_byzantine: int = 5, nb: int = None):
        # `nb` mirrors the reference ctor arg name
        self.b = nb if nb is not None else num_byzantine

    def _effective_b(self, k: int) -> int:
        b = self.b
        while k - 2 * b <= 0:  # auto-shrink, parity with the reference
            b -= 1
        if b < 0:
            raise RuntimeError(f"cannot trim {self.b} from {k} clients")
        return b

    def aggregate(self, updates, state=(), **ctx):
        return trimmed_mean(updates, self._effective_b(updates.shape[0])), state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        # b is further clamped to the participant count inside
        return masked_trimmed_mean(updates, mask, self._effective_b(updates.shape[0])), state

    def __repr__(self):
        return f"Trimmed Mean (b={self.b})"
