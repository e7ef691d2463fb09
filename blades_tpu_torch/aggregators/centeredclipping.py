"""Centered clipping (Karimireddy et al., ICML 2021).

Counterpart: ``blades_tpu/aggregators/centeredclipping.py:44``: a momentum
center ``v`` carried across rounds as the aggregator's state (a ``[D]``
float32 vector), and ``n_iter`` inner steps
``v <- v + mean_i clip(u_i - v, tau)`` with ``clip(x) = x * min(1, tau/|x|)``.
The masked form (JAX ``:58``) takes that mean over the participants only,
so an absent client neither pulls the center nor damps it, and a round
with none leaves it where it was.

The streaming form (JAX ``:76-121``): each chunk runs the ``n_iter`` steps
of the masked form from the round-start momentum ``v0``, and the finalize
takes the participant-count-weighted mean of the chunk momenta. With
``n_iter == 1`` that is the dense estimator (``streaming_exact``): one step
is ``v0 + mean_i clip(u_i - v0)``, and the weighted mean of chunk means
recombines it. With more steps each chunk re-centres on its own rows, a
two-level approximation. With one chunk, that chunk's momentum is the
result as it is.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.ops.streaming import stack_init, stack_write, weighted_stack_mean


class Centeredclipping(Aggregator):
    stateful = True

    def __init__(self, tau: float = 10.0, n_iter: int = 5):
        self.tau = tau
        self.n_iter = n_iter

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return torch.zeros(dim, dtype=torch.float32)

    def aggregate(self, updates, state, **ctx):
        momentum = state.to(updates.device, updates.dtype)
        for _ in range(self.n_iter):
            v = updates - momentum
            momentum = momentum + (v * self._scale(v)[:, None]).mean(dim=0)
        return momentum, momentum

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        momentum = state.to(updates.device, updates.dtype)
        m = mask.to(updates.dtype)
        denom = torch.clamp_min(m.sum(), 1.0)
        for _ in range(self.n_iter):
            v = updates - momentum
            # the 0/1 mask folded into the clip scale: exact, one pass fewer
            momentum = momentum + (v * (self._scale(v) * m)[:, None]).sum(dim=0) / denom
        return momentum, momentum

    def _scale(self, v):
        """Each row's clip factor ``min(1, tau / |v_i|)``."""
        norms = torch.sqrt(torch.clamp_min((v * v).sum(dim=1), 1e-24))
        return torch.clamp_max(self.tau / norms, 1.0)

    @property
    def streaming_exact(self):  # type: ignore[override]
        return self.n_iter == 1

    def streaming_init(self, num_clients, num_chunks, chunk_size, dim, state=(), *,
                       device="cpu"):
        v0 = (torch.zeros(dim, dtype=torch.float32) if isinstance(state, tuple) and state == ()
              else state)
        return {"v0": v0.to(device, torch.float32),
                "momenta": stack_init(num_chunks, (dim,), device=device),
                "counts": torch.zeros(num_chunks, dtype=torch.int32, device=device)}

    def streaming_update(self, sstate, chunk_updates, *, chunk_mask, chunk_index, **ctx):
        m_j, _ = self._masked_aggregate(chunk_updates, sstate["v0"], mask=chunk_mask)
        n = chunk_mask.to(torch.int32).sum(dtype=torch.int32)
        return {"v0": sstate["v0"],
                "momenta": stack_write(sstate["momenta"], chunk_index, m_j),
                "counts": stack_write(sstate["counts"], chunk_index, n)}

    def streaming_finalize(self, sstate, state=(), **ctx):
        momenta, counts = sstate["momenta"], sstate["counts"]
        v = momenta[0] if momenta.shape[0] == 1 else weighted_stack_mean(momenta, counts)
        # a round with no participant leaves the momentum at v0
        momentum = torch.where(counts.sum() > 0, v, sstate["v0"])
        return momentum, momentum

    def diagnostics(self, updates, state=(), **ctx):
        """Each client's distance from the round's incoming momentum centre
        (``clip_norms``) and whether the clip engaged on the first inner
        step (``clipped``: ``|u_i - v| > tau``), JAX ``:124-129``."""
        v = state.to(updates.device, updates.dtype)
        norms = torch.sqrt(torch.clamp_min(((updates - v) ** 2).sum(dim=1), 1e-24))
        return {"clip_norms": norms, "clipped": norms > self.tau}

    def __repr__(self):
        return f"Clipping (tau={self.tau}, n_iter={self.n_iter})"
