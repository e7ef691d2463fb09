"""Attack base class: three hooks into the round.

Counterpart: ``blades_tpu/attackers/base.py:19-111`` (``Attack``,
``NoAttack``, ``honest_stats``). The byzantine population is a boolean
``[K]`` mask over the client axis. Where the JAX hooks see one client under
``vmap``, these see the whole client axis written out, as the port's round
runs it:

``on_batch(x [K, B, ...], y [K, B], byz_mask [K], *, num_classes, generator, client_idx [K])``
    Per-train-step data corruption.

``on_grads(grads {name: [K, ...]}, byz_mask [K], client_idx [K])``
    Per-step gradient corruption.

``on_updates(updates [K, D], byz_mask [K], generator, state)``
    Post-training rewrite of the update matrix; returns ``(updates, state)``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch


class Attack:
    """Base class for Byzantine attacks (all hooks default to identity)."""

    #: True if a hook other than on_updates is non-trivial
    trains_dishonestly: bool = False

    #: ``"row"`` when each rewritten row reads only its own input row;
    #: ``"population"`` when byzantine rows come from population statistics
    update_locality: str = "row"

    #: None when every hook can be captured in a CUDA graph (no host sync,
    #: no generator state set inside the round), else why not; an engine
    #: with such an attack runs its round blocks eagerly
    #: (``RoundEngine.graph_block_reason``)
    graph_unsafe_reason: Optional[str] = None

    def init_state(self, num_clients: int, dim: int) -> Any:
        return ()

    def on_batch(
        self,
        x: torch.Tensor,
        y: torch.Tensor,
        byz_mask: torch.Tensor,
        *,
        num_classes: int,
        generator: Optional[torch.Generator] = None,
        client_idx: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return x, y

    def on_grads(self, grads, byz_mask: torch.Tensor, client_idx=None):
        return grads

    def on_updates(
        self,
        updates: torch.Tensor,
        byz_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        state: Any = (),
    ) -> Tuple[torch.Tensor, Any]:
        return updates, state

    def on_updates_batched(self, updates: torch.Tensor, byz_mask: torch.Tensor,
                           generators: list, states: list) -> Tuple[torch.Tensor, list]:
        """S experiments' :meth:`on_updates` (``ExperimentBatch(mode="vmap")``):
        ``updates`` ``[S, K, D]``, each experiment's generator and state.
        By default each experiment runs on its row ``s`` with its own
        generator (an attack that draws must, so that it draws what its own
        round draws); an attack that draws nothing may batch it."""
        outs = [self.on_updates(updates[s], byz_mask, g, st)
                for s, (g, st) in enumerate(zip(generators, states))]
        return torch.stack([u for u, _ in outs]), [st for _, st in outs]

    def __repr__(self) -> str:
        return type(self).__name__


class NoAttack(Attack):
    """All clients honest (reference: ``attack=None`` forces
    ``num_byzantine=0``)."""


def honest_stats(
    updates: torch.Tensor, byz_mask: torch.Tensor, part_mask: torch.Tensor = None
):
    """Masked per-coordinate mean and unbiased (ddof=1) std over honest rows,
    and the honest count. Zero honest rows give ``mu = std = 0``; one honest
    row gives ``std = 0`` (the divisor is ``max(n - 1, 1)``, where
    ``torch.std`` would divide by zero)."""
    honest_rows = ~byz_mask if part_mask is None else (~byz_mask & part_mask)
    honest = honest_rows.to(updates.dtype)[:, None]
    n = torch.clamp_min(honest.sum(), 1.0)
    mu = (updates * honest).sum(dim=0) / n
    var = ((updates - mu) ** 2 * honest).sum(dim=0) / torch.clamp_min(n - 1.0, 1.0)
    return mu, torch.sqrt(var), n
