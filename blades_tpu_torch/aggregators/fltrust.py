"""FLTrust (Cao et al., NDSS 2021).

Counterpart: ``blades_tpu/aggregators/fltrust.py`` (the host guard in
``__call__`` :46, ``_trust_scores`` :54, ``aggregate`` :67). Exactly one
client is trusted (``trusted_mask``, set through
``Simulator.set_trusted_clients``); every other client's trust is
``relu(cos(trusted, u_i))`` (cosine eps 1e-6), every update is rescaled to
the trusted update's norm, and the result is the trust-weighted average;
all trust 0 gives the zero vector. The rescale is folded into the weights,
so the average is one matrix-vector product. In the masked form (JAX
``:80``) an absent client earns no trust; when the trusted client itself
is absent its zeroed row zeroes every cosine, and the round is the zero
update.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator


class Fltrust(Aggregator):
    # certification opt-out (JAX ``fltrust.py:29``)
    audit_optouts = {
        "translation": "cosine trust scores and trusted-norm rescaling are "
                       "origin-anchored; the defense is deliberately not "
                       "translation-equivariant",
    }

    # no streaming form (JAX ``fltrust.py:40-44``)
    streaming_optouts = {
        "streaming": "trust reweighting pairs every row with the trusted "
                     "update, which may arrive in any chunk; a single pass "
                     "cannot revisit rows delivered before it",
    }

    def __call__(self, inputs, **ctx):
        # host-side guard, the reference's `assert len(trusted) == 1`
        mask = ctx.get("trusted_mask")
        if mask is not None and int(torch.as_tensor(mask).sum()) != 1:
            raise ValueError("fltrust requires exactly one trusted client")
        return super().__call__(inputs, **ctx)

    @staticmethod
    def _trust_scores(updates, trusted_mask):
        """``(ts, t_norm, norms)``: the relu'd cosine trust of each client (0
        for the trusted one), the trusted update's norm, every norm."""
        trusted_mask = torch.as_tensor(trusted_mask, device=updates.device).to(torch.bool)
        first = torch.argmax(trusted_mask.to(torch.int32)).view(1)
        trusted = updates.index_select(0, first)[0]
        t_norm = torch.sqrt((trusted * trusted).sum())
        norms = torch.linalg.vector_norm(updates, dim=1)
        cos = (updates @ trusted) / torch.clamp_min(norms * t_norm, 1e-6)
        ts = torch.clamp_min(cos, 0.0) * (~trusted_mask)
        return ts, t_norm, norms

    def aggregate(self, updates, state=(), *, trusted_mask=None, **ctx):
        if trusted_mask is None:
            raise ValueError("fltrust requires a trusted_mask (set_trusted_clients)")
        return self._weighted(updates, *self._trust_scores(updates, trusted_mask)), state

    def _masked_aggregate(self, updates, state, *, mask, trusted_mask=None, **ctx):
        if trusted_mask is None:
            raise ValueError("fltrust requires a trusted_mask (set_trusted_clients)")
        ts, t_norm, norms = self._trust_scores(updates, trusted_mask)
        return self._weighted(updates, ts * mask.to(updates.dtype), t_norm, norms), state

    def diagnostics(self, updates, state=(), *, trusted_mask=None, **ctx):
        """``trust_scores [K]``: the weights :meth:`aggregate` applies this
        round, from the same ``_trust_scores`` call (JAX ``:95-101``); ``{}``
        without a trusted mask."""
        if trusted_mask is None:
            return {}
        ts, _, _ = self._trust_scores(updates, trusted_mask)
        return {"trust_scores": ts}

    @staticmethod
    def _weighted(updates, ts, t_norm, norms):
        """The trust-weighted average of the updates rescaled to the trusted
        norm."""
        w = ts * (t_norm / torch.clamp_min(norms, 1e-24))
        return (w @ updates) / torch.clamp_min(ts.sum(), 1e-12)
