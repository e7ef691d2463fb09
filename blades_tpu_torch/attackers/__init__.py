"""Byzantine attack registry.

Counterpart: ``blades_tpu/attackers/__init__.py:37-61`` (``ATTACKS``,
``get_attack``): every name of the JAX registry resolves here, and ``None``
is no attack. Per-client composites of several attacks are
``Simulator.register_attackers`` (``simulator.py:_CompositeAttack``).
"""

from __future__ import annotations

from typing import Dict, Type, Union

from blades_tpu_torch.attackers.alie import Alie
from blades_tpu_torch.attackers.base import Attack, NoAttack, honest_stats
from blades_tpu_torch.attackers.ipm import Ipm
from blades_tpu_torch.attackers.labelflipping import Labelflipping
from blades_tpu_torch.attackers.minmax import Minmax, Minsum
from blades_tpu_torch.attackers.noise import Noise
from blades_tpu_torch.attackers.signflipping import Signflipping

ATTACKS: Dict[str, Type[Attack]] = {
    "noise": Noise,
    "labelflipping": Labelflipping,
    "signflipping": Signflipping,
    "alie": Alie,
    "ipm": Ipm,
    "minmax": Minmax,
    "minsum": Minsum,
}


def get_attack(name: Union[str, Attack, None], **kwargs) -> Attack:
    """Resolve an attack by registry name or pass an :class:`Attack`
    instance through."""
    if name is None:
        return NoAttack()
    if isinstance(name, Attack):
        return name
    try:
        cls = ATTACKS[name]
    except KeyError:
        raise ValueError(
            f"Unknown attack {name!r}; available: {sorted(ATTACKS)}"
        ) from None
    return cls(**kwargs)


__all__ = [
    "ATTACKS", "Alie", "Attack", "Ipm", "Labelflipping", "Minmax", "Minsum",
    "NoAttack", "Noise", "Signflipping", "get_attack", "honest_stats",
]
