"""CITE001: every ``blades_tpu_torch/`` module docstring names its
counterpart.

Counterpart: ``blades_tpu/analysis/rules/citations.py:77`` (``Cite001``),
whose docstring check this module copies. The port is held to the JAX
package module by module (``ROADMAP.md``, north star): a reader of a port
module must find the JAX file it stands for, a reference file, or an
explicit statement that there is none.

A module passes when its docstring (1) mentions the parity vocabulary
(``reference`` / ``counterpart`` / ``SURVEY.md``) AND (2) either cites a
concrete file (``blades_tpu/ops/pallas_trimmed.py:91`` preferred; a bare
``file.py`` accepted for whole-file counterparts) or carries an explicit
no-counterpart marker. The JAX rule's markers ("reference counterpart:
none", "not in the reference", ...) are extended with the port's own
"No counterpart in ``blades_tpu``" (``ops/_build.py:3``).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from blades_tpu_torch.analysis.core import RepoIndex, Rule, Violation

# the docstring talks about parity at all
VOCAB_RE = re.compile(r"reference|counterpart|SURVEY\.md", re.I)
# a concrete file citation; line numbers preferred but whole-file accepted
FILE_RE = re.compile(r"[\w/.-]+\.(py|sh|rst|md|cc|ipynb)(:\d+(-\d+)?)?")
# explicit "this is new surface" markers: the JAX rule's, and the port's
NONE_RE = re.compile(
    r"reference counterpart: none"
    r"|no (direct )?reference counterpart"
    r"|not in the reference"
    r"|beyond the reference"
    r"|absent in the reference"
    r"|the reference (has|ships) no"
    r"|reference has no equivalent"
    r"|no counterpart in `*blades_tpu\b",
    re.I,
)


def check_docstring(doc: Optional[str], rel: str) -> Optional[str]:
    """Violation message for one module docstring, or None when it
    conforms."""
    if not doc:
        return f"{rel}: missing module docstring (citation convention)"
    if not VOCAB_RE.search(doc):
        return (
            f"{rel}: docstring never mentions its reference counterpart "
            "(add a `file:line` citation or an explicit "
            "'reference counterpart: none')"
        )
    if not (FILE_RE.search(doc) or NONE_RE.search(doc)):
        return (
            f"{rel}: docstring mentions the reference but cites no "
            "`file:line` (and carries no explicit no-counterpart marker)"
        )
    return None


class Cite001(Rule):
    id = "CITE001"
    severity = "error"
    rationale = (
        "The port is held to the JAX package module by module; each port "
        "module's docstring names its blades_tpu counterpart (ROADMAP.md "
        "north star; the citation convention of blades_tpu's CITE001)."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        for mod in index.under("blades_tpu_torch"):
            if mod.tree is None:
                continue
            msg = check_docstring(ast.get_docstring(mod.tree), mod.rel)
            if msg is not None:
                out.append(
                    self.violation(mod, 1, msg.split(": ", 1)[-1])
                )
        return out
