"""Byzantine attack registry.

Counterpart: ``blades_tpu/attackers/__init__.py:37-61`` (``ATTACKS``,
``get_attack``). Ported so far: ``alie`` and ``None`` (no attack). The other
names of the JAX registry raise and name the ``ROADMAP.md`` slice that
brings them.
"""

from __future__ import annotations

from typing import Dict, Type, Union

from blades_tpu_torch.attackers.alie import Alie
from blades_tpu_torch.attackers.base import Attack, NoAttack, honest_stats

ATTACKS: Dict[str, Type[Attack]] = {
    "alie": Alie,
}

#: names of the JAX registry still to port (ROADMAP.md queue A, slice 3)
UNPORTED = ("noise", "labelflipping", "signflipping", "ipm", "minmax", "minsum")


def get_attack(name: Union[str, Attack, None], **kwargs) -> Attack:
    """Resolve an attack by registry name or pass an :class:`Attack`
    instance through."""
    if name is None:
        return NoAttack()
    if isinstance(name, Attack):
        return name
    if name in UNPORTED:
        raise NotImplementedError(
            f"attack {name!r} is not ported to blades_tpu_torch yet "
            "(ROADMAP.md queue A, slice 3)"
        )
    try:
        cls = ATTACKS[name]
    except KeyError:
        raise ValueError(
            f"Unknown attack {name!r}; available: {sorted(ATTACKS)}"
        ) from None
    return cls(**kwargs)


__all__ = ["ATTACKS", "Alie", "Attack", "NoAttack", "get_attack", "honest_stats"]
