"""Rule registry for the port's Tier-A lints.

Counterpart: ``blades_tpu/analysis/rules/__init__.py`` (``all_rules``,
``_RULE_CLASSES``), copied with the port's rules under the JAX IDs and
file names. Each module here defines one or two
:class:`~blades_tpu_torch.analysis.core.Rule` subclasses; :func:`all_rules`
instantiates the full set in a stable order. Adding a rule = adding a
module here, registering it in ``_RULE_CLASSES`` and seeding a fixture
under ``tests/fixtures/analysis_torch/<ruleid>/`` (the fixture test
enforces it).
"""

from __future__ import annotations

from typing import List

from blades_tpu_torch.analysis.core import Rule
from blades_tpu_torch.analysis.rules.aliasing import Alias001
from blades_tpu_torch.analysis.rules.citations import Cite001
from blades_tpu_torch.analysis.rules.host_sync import Sync001
from blades_tpu_torch.analysis.rules.imports import Imp001, Imp002
from blades_tpu_torch.analysis.rules.json_contract import Json001
from blades_tpu_torch.analysis.rules.pallas import Pal001
from blades_tpu_torch.analysis.rules.schema_drift import Schema001
from blades_tpu_torch.analysis.rules.telemetry_io import Tel001
from blades_tpu_torch.analysis.rules.xla_flags import Xla001

_RULE_CLASSES = (
    Alias001,
    Xla001,
    Imp001,
    Imp002,
    Sync001,
    Pal001,
    Tel001,
    Json001,
    Cite001,
    Schema001,
)


def all_rules() -> List[Rule]:
    """Fresh instances of every registered rule, stable order."""
    return [cls() for cls in _RULE_CLASSES]


__all__ = ["all_rules"] + [cls.__name__ for cls in _RULE_CLASSES]
