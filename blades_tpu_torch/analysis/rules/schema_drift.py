"""SCHEMA001: every statically-emitted telemetry record type is declared
in the port's committed schema.

Counterpart: ``blades_tpu/analysis/rules/schema_drift.py:60``
(``Schema001``), copied, over the port's tree and its schema
``blades_tpu_torch/telemetry/telemetry_schema.json``. The dynamic
validator (``python -m blades_tpu_torch.telemetry.schema``, and the tests
that run it on a real trace) only sees the record types that run emits;
this rule scans ``blades_tpu_torch/`` for every literal record type —
``rec.event("<type>", ...)`` first arguments and ``{"t": "<type>", ...}``
dict literals — and fails when one is missing from the schema, so a new
record type cannot land without declaring itself.
"""

from __future__ import annotations

import ast
import json
from typing import Dict, List, Tuple

from blades_tpu_torch.analysis.core import RepoIndex, Rule, Violation

SCHEMA_REL = "blades_tpu_torch/telemetry/telemetry_schema.json"


def emitted_types(index: RepoIndex) -> List[Tuple[str, str, int]]:
    """(type, rel_path, line) for every statically-visible record emit in
    ``blades_tpu_torch/``."""
    out: List[Tuple[str, str, int]] = []
    for mod in index.under("blades_tpu_torch"):
        if mod.tree is None:
            continue
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "event"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                out.append((node.args[0].value, mod.rel, node.lineno))
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (
                        isinstance(k, ast.Constant)
                        and k.value == "t"
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str)
                    ):
                        out.append((v.value, mod.rel, node.lineno))
    return out


class Schema001(Rule):
    id = "SCHEMA001"
    severity = "error"
    rationale = (
        "Record types drift silently from the committed schema; the "
        "dynamic validator (telemetry/schema.py) only covers the types a "
        "test run happens to emit."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        raw = index.text(SCHEMA_REL)
        emits = emitted_types(index)
        if raw is None:
            if not emits:
                return []  # tree without telemetry surface (fixtures)
            return [
                Violation(
                    rule=self.id,
                    path=SCHEMA_REL,
                    line=0,
                    message="telemetry record emits exist but the schema "
                    "file is missing",
                )
            ]
        try:
            declared: Dict = json.loads(raw).get("types", {})
        except (json.JSONDecodeError, AttributeError) as e:
            return [
                Violation(
                    rule=self.id,
                    path=SCHEMA_REL,
                    line=0,
                    message=f"schema file does not parse: {e}",
                )
            ]
        out: List[Violation] = []
        for t, rel, line in emits:
            if t not in declared:
                out.append(
                    Violation(
                        rule=self.id,
                        path=rel,
                        line=line,
                        message=f"record type {t!r} is emitted here but not "
                        f"declared in {SCHEMA_REL} — declare it there",
                    )
                )
        return out
