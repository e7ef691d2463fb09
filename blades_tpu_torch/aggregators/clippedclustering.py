"""Clipped clustering (Li et al., TechRxiv 2022).

Counterpart: ``blades_tpu/aggregators/clippedclustering.py:78``: append the
round's K update norms to a history, clip every row whose norm exceeds the
history's median (or a fixed ``tau``) down to it with the reference's
``min(1, tau / (|u| + 1e-6))``, then cluster on cosine distance
(``Clustering(metric='distance')``) and average the larger group.

The history is the JAX package's fixed ring buffer, carried as the
aggregator's state: ``history_cap`` float32 norms, the write position
``pos`` and the live count ``count`` (0-d int32). Its median is the
midpoint of the two central live entries. All of it stays on the device.

The masked form (JAX ``:101``) keeps the K writes a round: an absent
client's slot records the round's participant median, which leaves the
history's median where the participants put it, and a round with no
participant leaves the whole history (values, ``pos``, ``count``) as it
was. Clustering then runs in its masked form.

The streaming form (JAX ``:142-237``) clips with the round-start (lagged)
threshold, the history's median before this round's norms, which a single
pass cannot know in advance; each chunk then clusters its clipped rows, and
the finalize clusters the chunk aggregates. The ring takes exactly K norms
a round, in pass order: the final chunk's padding writes nothing, and a
chunk with no participant writes nothing at all.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.aggregators.clustering import Clustering
from blades_tpu_torch.ops.masked import masked_median_1d
from blades_tpu_torch.ops.streaming import stack_init, stack_write


def masked_median(norms: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Median of the first ``n`` entries (0-d tensor ``n``; numpy's
    midpoint of the two central values for even n)."""
    cap = norms.shape[0]
    filled = torch.arange(cap, device=norms.device) < n
    s = torch.sort(torch.where(filled, norms, float("inf"))).values
    lo = s.index_select(0, torch.clamp_min((n - 1) // 2, 0).view(1))[0]
    hi = s.index_select(0, torch.clamp_min(n // 2, 0).view(1))[0]
    return (lo + hi) / 2.0


class Clippedclustering(Aggregator):
    stateful = True

    # certification opt-out (JAX ``clippedclustering.py:48``)
    audit_optouts = {
        "translation": "median-norm clipping and cosine-distance clustering "
                       "are origin-anchored; a global translation changes "
                       "the clip and cluster decisions",
    }

    def __init__(self, tau: float = None, history_cap: int = 65536):
        self.tau = tau
        self.history_cap = history_cap
        self._clustering = Clustering(metric="distance")

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return {
            "norms": torch.zeros(self.history_cap, dtype=torch.float32),
            "pos": torch.zeros((), dtype=torch.int32),
            "count": torch.zeros((), dtype=torch.int32),
        }

    def aggregate(self, updates, state, **ctx):
        norms = torch.linalg.vector_norm(updates, dim=1)
        new_state = self._append(state, norms.to(torch.float32), None)
        clipped = self._clip(updates, norms, self._threshold(new_state, updates))
        agg, _ = self._clustering.aggregate(clipped)
        return agg, new_state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        norms = torch.linalg.vector_norm(updates, dim=1)
        writes = torch.where(mask, norms, masked_median_1d(norms, mask)).to(torch.float32)
        new_state = self._append(state, writes, mask.any())
        clipped = self._clip(updates, norms, self._threshold(new_state, updates))
        agg, _ = self._clustering._masked_aggregate(clipped, (), mask=mask)
        return agg, new_state

    def _append(self, state, writes, gate):
        """The ring buffer with ``writes`` appended; with a 0-d bool ``gate``
        that is False, the buffer as it was."""
        dev, k, cap = writes.device, writes.shape[0], self.history_cap
        old = {n: state[n].to(dev) for n in ("norms", "pos", "count")}
        idx = (old["pos"] + torch.arange(k, device=dev)) % cap
        new = {"norms": old["norms"].index_copy(0, idx, writes), "pos": (old["pos"] + k) % cap,
               "count": torch.clamp_max(old["count"] + k, cap)}
        if gate is None:
            return new
        return {n: torch.where(gate, new[n], old[n]) for n in new}

    def _threshold(self, state, like):
        """The clipping threshold, ``tau`` or the history's median, as a 0-d
        tensor of ``like``'s dtype and device."""
        if self.tau is not None:
            return torch.full((), self.tau, dtype=like.dtype, device=like.device)
        return masked_median(state["norms"], state["count"]).to(like.dtype)

    @staticmethod
    def _clip(updates, norms, threshold):
        """Rows whose norm passes ``threshold`` scaled down to it."""
        coef = torch.clamp_max(threshold / (norms + 1e-6), 1.0)
        return torch.where((norms > threshold)[:, None], updates * coef[:, None], updates)

    # -- streaming -------------------------------------------------------------

    def streaming_init(self, num_clients, num_chunks, chunk_size, dim, state=(), *,
                       device="cpu"):
        ring = {n: state[n].to(device) for n in ("norms", "pos", "count")}
        return {**ring,
                # the round-start threshold, from the history before this round
                "thresh": self._threshold(ring, ring["norms"]),
                # the padding rows of the final chunk, which write no norm
                "pad": num_chunks * chunk_size - num_clients, "last": num_chunks - 1,
                "aggs": stack_init(num_chunks, (dim,), device=device),
                "counts": torch.zeros(num_chunks, dtype=torch.int32, device=device)}

    def streaming_update(self, sstate, chunk_updates, *, chunk_mask, chunk_index, **ctx):
        k = chunk_updates.shape[0]
        norms = torch.linalg.vector_norm(chunk_updates, dim=1)
        n = chunk_mask.to(torch.int32).sum(dtype=torch.int32)
        # absent clients' slots record the chunk's participant median
        writes = torch.where(chunk_mask, norms, masked_median_1d(norms, chunk_mask))
        n_slots = k - (sstate["pad"] if chunk_index == sstate["last"] else 0)
        ring = self._append(sstate, writes[:n_slots].to(torch.float32), n > 0)
        clipped = self._clip(chunk_updates, norms, sstate["thresh"].to(chunk_updates.dtype))
        if k == 1:
            agg = clipped[0]
        else:
            agg, _ = self._clustering._masked_aggregate(clipped, (), mask=chunk_mask)
        agg = torch.where(n > 0, agg, torch.zeros_like(agg))
        return {**sstate, **ring, "aggs": stack_write(sstate["aggs"], chunk_index, agg),
                "counts": stack_write(sstate["counts"], chunk_index, n)}

    def streaming_finalize(self, sstate, state=(), **ctx):
        aggs, counts = sstate["aggs"], sstate["counts"]
        new_state = {n: sstate[n] for n in ("norms", "pos", "count")}
        if aggs.shape[0] == 1:
            agg = aggs[0]
        else:
            agg, _ = self._clustering._masked_aggregate(aggs, (), mask=counts > 0)
        return torch.where(counts.sum() > 0, agg, torch.zeros_like(agg)), new_state
