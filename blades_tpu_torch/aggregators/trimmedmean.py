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
``diagnostics`` (JAX ``:49-66``) counts, per client, the coordinates where
its value was trimmed, with the ranks of JAX's stable double argsort.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator, TwoLevelStreaming
from blades_tpu_torch.ops.masked import masked_trimmed_mean
from blades_tpu_torch.ops.trimmed import trimmed_mean

#: ``diagnostics`` sorts this many elements at a time (columns in slabs of
#: ``TRIM_SLAB_ELEMS // K``), which bounds the sort's buffers
TRIM_SLAB_ELEMS = 1 << 26


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

    def diagnostics(self, updates, state=(), **ctx):
        """``trim_counts [K]`` (int32): per client, the coordinates where its
        value ranked below ``b`` or at ``K - b`` and above along the client
        axis, i.e. was trimmed; ``trim_b``: the effective b (0-d int32).

        JAX ranks with ``argsort(argsort(u, 0), 0)``, both stable: ties
        (ALIE writes f identical rows) go to the lower client index. The
        rows at sorted positions ``j < b`` and ``j >= K - b`` of one stable
        argsort are the trimmed ones, so they are counted directly (a
        scatter of ``2b`` rows of indices) instead of inverting the
        permutation. The sort keys are ``u + 0.0``: JAX's comparator treats
        -0.0 and 0.0 as equal, and ``+ 0.0`` maps -0.0 to 0.0. Columns go in
        slabs of :data:`TRIM_SLAB_ELEMS` elements."""
        k, d = updates.shape
        b = self._effective_b(k)
        counts = torch.zeros(k, dtype=torch.int32, device=updates.device)
        if b > 0:
            ones = torch.ones(1, dtype=torch.int32, device=updates.device)
            cols = max(1, TRIM_SLAB_ELEMS // k)
            for lo in range(0, d, cols):
                idx = torch.argsort(updates[:, lo:lo + cols] + 0.0, dim=0, stable=True)
                trimmed = torch.cat([idx[:b], idx[k - b:]]).reshape(-1)
                del idx
                counts.scatter_add_(0, trimmed, ones.expand(trimmed.numel()))
        return {"trim_counts": counts,
                "trim_b": torch.full((), b, dtype=torch.int32, device=updates.device)}

    def __repr__(self):
        return f"Trimmed Mean (b={self.b})"
