"""Aggregator protocol.

Counterpart: ``blades_tpu/aggregators/base.py:35-306`` (``Aggregator``). An
aggregator is a function over the on-device ``[K, D]`` update matrix,

    aggregate(updates, state, **ctx) -> (aggregated [D], new_state)

with any cross-round state threaded explicitly. ``__call__`` is the
convenience wrapper with reference-call parity (a stacked matrix, a list of
vectors, or a list of client handles) that keeps the state itself.

The context an aggregator may read: ``byz_mask``, ``trusted_mask``
(FLTrust), ``params_flat`` (ByzantineSGD), ``generator`` (the round's
``utils/rng.py:AGG`` generator, where the JAX package passes ``key``; DnC
draws from it) and ``weights`` (GeoMed's initial client weights).

The mask-aware path (``aggregate_masked``, JAX ``:89-137``) aggregates over
the participating clients of a ``[K]`` mask (``blades_tpu_torch.faults``);
each registered aggregator implements ``_masked_aggregate``. Not ported
yet: its diagnostics variant (``ROADMAP.md`` queue A slice 10) and the
streaming protocol (slice 8), which raises when called.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch


class Aggregator:
    """Base class for robust aggregators. Construction-time hyperparameters
    are plain Python attributes."""

    #: set by subclasses that carry state across rounds
    stateful: bool = False

    #: certification-contract opt-outs, ``{contract: reason}`` (class-level,
    #: never mutated; the audit battery comes with slice 10)
    audit_optouts: dict = {}

    #: streaming-protocol opt-outs, ``{"streaming": reason}`` (slice 8)
    streaming_optouts: dict = {}

    #: True when the streaming form computes the dense estimator (slice 8)
    streaming_exact: bool = False

    def init_state(self, num_clients: int, dim: int) -> Any:
        """Initial carry for stateful aggregators; ``()`` when stateless."""
        return ()

    def aggregate(
        self,
        updates: torch.Tensor,
        state: Any = (),
        *,
        byz_mask: Optional[torch.Tensor] = None,
        trusted_mask: Optional[torch.Tensor] = None,
        params_flat: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        weights: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    # -- partial participation ---------------------------------------------------

    def aggregate_masked(
        self, updates: torch.Tensor, state: Any = (), *,
        mask: Optional[torch.Tensor] = None, **ctx,
    ) -> Tuple[torch.Tensor, Any]:
        """:meth:`aggregate` over the clients that ``mask`` (boolean ``[K]``)
        marks as participating. A masked-out row cannot influence the
        result: its payload may be stale, NaN or Inf, and it is zeroed before
        :meth:`_masked_aggregate` sees it. ``mask=None`` is :meth:`aggregate`
        itself."""
        if mask is None:
            return self.aggregate(updates, state, **ctx)
        mask, safe = self._sanitize(updates, mask)
        return self._masked_aggregate(safe, state, mask=mask, **ctx)

    @staticmethod
    def _sanitize(updates, mask):
        """The mask as bool on the updates' device, and the updates with
        masked-out rows set to 0 by ``where``: multiplying by the mask would
        keep a NaN row NaN (``NaN * 0`` is NaN)."""
        mask = torch.as_tensor(mask).to(updates.device, torch.bool)
        return mask, torch.where(mask[:, None], updates, 0.0)

    def _masked_aggregate(
        self, updates: torch.Tensor, state: Any, *, mask: torch.Tensor, **ctx
    ) -> Tuple[torch.Tensor, Any]:
        """The mask-aware core; ``updates`` arrives with masked-out rows
        zeroed. Every registered aggregator overrides it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement mask-aware "
            "aggregation (_masked_aggregate)"
        )

    def supports_streaming(self) -> bool:
        return False

    def streaming_init(self, *args, **kwargs):
        raise NotImplementedError(self._no_streaming_msg())

    def streaming_update(self, *args, **kwargs):
        raise NotImplementedError(self._no_streaming_msg())

    def streaming_finalize(self, *args, **kwargs):
        raise NotImplementedError(self._no_streaming_msg())

    def _no_streaming_msg(self) -> str:
        return (
            f"{type(self).__name__}: streaming aggregation is not ported to "
            "blades_tpu_torch yet (ROADMAP.md queue A, slice 8)"
        )

    # -- host-side convenience ------------------------------------------------

    def _coerce(self, inputs) -> torch.Tensor:
        """A stacked ``[K, D]`` matrix from a matrix, a list of vectors, or a
        list of client handles (reference ``_get_updates``)."""
        if isinstance(inputs, (list, tuple)):
            if len(inputs) and hasattr(inputs[0], "get_update"):
                inputs = [c.get_update() for c in inputs]
            return torch.stack([torch.as_tensor(u) for u in inputs], dim=0)
        return torch.as_tensor(inputs)

    def __call__(self, inputs, **ctx) -> torch.Tensor:
        updates = self._coerce(inputs)
        if not hasattr(self, "_state"):
            self._state = self.init_state(*updates.shape)
        agg, self._state = self.aggregate(updates, self._state, **ctx)
        return agg

    def reset(self) -> None:
        if hasattr(self, "_state"):
            del self._state

    def __repr__(self) -> str:
        return type(self).__name__
