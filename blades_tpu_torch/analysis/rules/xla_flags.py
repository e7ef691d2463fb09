"""XLA001: the card's numeric switches are set only in ``utils/platform.py``.

Counterpart: ``blades_tpu/analysis/rules/xla_flags.py:36`` (``Xla001``),
which keeps raw ``XLA_FLAGS`` text inside the JAX package's
``utils/platform.py``. The port has no XLA flags; its counterpart is the
set of process-wide switches that decide which numbers a CUDA run gives
(cuDNN's deterministic algorithms and benchmark search, TF32 for matmuls
and convolutions, the float32 matmul precision, deterministic
algorithms). ``utils/platform.py`` owns them (``apply_numerics``,
``set_numerics``, ``numerics_scope``): a bit-for-bit claim (a graph block
against its rounds, a resume, a chaos twin) holds only under the
switches the driver set, and a second place that flips one changes the
numbers of every later phase of the process.

The rule: outside ``blades_tpu_torch/utils/platform.py``, no assignment to
``torch.backends.cudnn.{deterministic,benchmark,allow_tf32}`` or
``torch.backends.cuda.matmul.allow_tf32`` (nor a ``setattr`` of one), and
no call of ``torch.set_float32_matmul_precision``,
``torch.use_deterministic_algorithms`` or ``torch.backends.cudnn.flags``.
Reading a switch is fine.
"""

from __future__ import annotations

import ast
from typing import List

from blades_tpu_torch.analysis.core import RepoIndex, Rule, Violation, dotted_name

_OWNER_SUFFIX = "blades_tpu_torch/utils/platform.py"

#: the switches, as attribute paths
SWITCHES = (
    "torch.backends.cudnn.deterministic",
    "torch.backends.cudnn.benchmark",
    "torch.backends.cudnn.allow_tf32",
    "torch.backends.cuda.matmul.allow_tf32",
)
#: the calls that set one
SETTERS = (
    "torch.set_float32_matmul_precision",
    "torch.use_deterministic_algorithms",
    "torch.backends.cudnn.flags",
)


def _switch_of(name: str) -> str:
    """The switch a dotted name spells (``torch.backends.cudnn.benchmark``,
    or with ``torch.`` left out after ``from torch import backends``)."""
    for s in SWITCHES:
        if name == s or name == s[len("torch."):]:
            return s
    return ""


class Xla001(Rule):
    id = "XLA001"
    severity = "error"
    rationale = (
        "The card's numeric switches decide every bit-for-bit claim of a "
        "run; utils/platform.py is their one owner (apply_numerics), so no "
        "phase flips one behind another's back."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        for mod in index.files:
            if mod.tree is None or mod.rel.endswith(_OWNER_SUFFIX):
                continue
            for node in ast.walk(mod.tree):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                        switch = _switch_of(dotted_name(el))
                        if switch:
                            out.append(self.violation(
                                mod, node, f"assignment to {switch} outside "
                                "utils/platform.py — set it with platform."
                                "set_numerics() or numerics_scope()"))
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name in SETTERS or (name and "torch." + name in SETTERS):
                    out.append(self.violation(
                        mod, node, f"{name}() outside utils/platform.py sets a numeric "
                        "switch of the card — route it through utils/platform.py"))
                elif (
                    name == "setattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and _switch_of(f"{dotted_name(node.args[0])}.{node.args[1].value}")
                ):
                    out.append(self.violation(
                        mod, node, "setattr of a numeric switch outside "
                        "utils/platform.py — use platform.set_numerics()"))
        return out
