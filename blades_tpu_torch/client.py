"""Client handles: host-side views into the batched population.

Counterpart: ``blades_tpu/client.py:25-88``. A client is an index into the
stacked ``[K, ...]`` tensors; these handles exist for API parity
(``get_clients``, ``trust``, ``is_byzantine``, ``get_update``).
"""

from __future__ import annotations

from typing import Optional

import torch

from blades_tpu_torch.attackers.base import Attack


class BladesClient:
    """Honest client handle."""

    _is_byzantine: bool = False

    def __init__(self, id: Optional[int] = None, device=None):
        self._id = id
        self._is_trusted = False
        self._update = None  # row of the last round's update matrix

    def id(self):
        return self._id

    def is_byzantine(self) -> bool:
        return self._is_byzantine

    def trust(self, trusted: bool = True) -> None:
        """Mark trusted (consumed by FLTrust)."""
        self._is_trusted = bool(trusted)

    def is_trusted(self) -> bool:
        return self._is_trusted

    def get_update(self) -> Optional[torch.Tensor]:
        """Last uploaded update vector (set by the simulator after each round
        when ``retain_updates`` is on)."""
        return self._update

    def save_update(self, update: torch.Tensor) -> None:
        self._update = update

    def __str__(self) -> str:
        return "BladesClient"

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self._id})"


class ByzantineClient(BladesClient):
    """Byzantine client handle; carries the attack applied to its row(s)."""

    _is_byzantine = True

    def __init__(self, *args, attack: Optional[Attack] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self._attack = attack

    def make_attack(self) -> Optional[Attack]:
        """The attack for this client (default: the ``attack=`` argument)."""
        return self._attack

    def omniscient_callback(self, updates, byz_mask, generator=None, state=()):
        """Rewrite the ``[K, D]`` update matrix; delegates to the attack."""
        attack = self.make_attack()
        if attack is None:
            return updates, state
        return attack.on_updates(updates, byz_mask, generator, state)

    def __str__(self) -> str:
        return "ByzantineClient"
