"""Aggregator protocol.

Counterpart: ``blades_tpu/aggregators/base.py:35-306`` (``Aggregator``). An
aggregator is a function over the on-device ``[K, D]`` update matrix,

    aggregate(updates, state, **ctx) -> (aggregated [D], new_state)

with any cross-round state threaded explicitly. ``__call__`` is the
convenience wrapper with reference-call parity (a stacked matrix, a list of
vectors, or a list of client handles) that keeps the state itself.

The context an aggregator may read: ``byz_mask``, ``trusted_mask``
(FLTrust), ``params_flat``, ``generator`` (the round's ``utils/rng.py:AGG``
generator, where the JAX package passes ``key``; DnC draws from it) and
``weights`` (GeoMed's initial client weights). Not ported yet, and raising
when called: the mask-aware path (``aggregate_masked``, ``ROADMAP.md``
queue A slice 6b) and the streaming protocol (slice 8).
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

    def aggregate_masked(self, updates, state=(), *, mask=None, **ctx):
        raise NotImplementedError(
            f"{type(self).__name__}: mask-aware aggregation is not ported to "
            "blades_tpu_torch yet (ROADMAP.md queue A, slice 6b)"
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
