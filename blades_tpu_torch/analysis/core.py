"""Rule engine for the port's Tier-A static lints: file index, pragma
handling, rule base class, and the runner.

Counterpart: ``blades_tpu/analysis/core.py:29-226``, copied line for line
but for the roots the index walks (:data:`DEFAULT_ROOTS`: the port's
package, ``chip_smoke.py`` and ``kernel_stages.py``). The port keeps its
own copy, as it keeps its own of every stdlib-only JAX module.

Design constraints:

- **stdlib only** (``ast``/``os``/``re``): Tier A runs, and gates, with no
  torch in the process, and importing it from tests costs no backend.
- **Every rule names its incident.** Each rule class carries a
  ``rationale`` citing the PR or the ``ROADMAP.md`` rule that motivated
  it, and the message repeats the consequence.
- **Suppression is visible.** ``# blades: allow[RULE001]`` on the
  violating line (or on a comment line directly above it) waives that
  rule there; waivers are counted and reported, never silent.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: Directories / files scanned relative to the repo root. tests/ is
#: deliberately excluded: it is the enforcement layer itself and its
#: fixtures (tests/fixtures/analysis_torch/) contain deliberate violations.
DEFAULT_ROOTS = (
    "blades_tpu_torch",
    "chip_smoke.py",
    "kernel_stages.py",
)

_SKIP_DIRS = {"__pycache__", ".jax_cache", ".git", "node_modules"}

_PRAGMA_RE = re.compile(r"#\s*blades:\s*allow\[([A-Za-z0-9_*,\s]+)\]")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule violation at a source location (``path`` repo-relative)."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class ModuleSource:
    """One parsed source file: AST, raw lines, and suppression pragmas."""

    def __init__(self, abspath: str, rel: str):
        self.abspath = abspath
        self.rel = rel
        with open(abspath, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.source, filename=rel)
        except SyntaxError as e:  # surfaced by the runner as its own finding
            self.parse_error = f"{type(e).__name__}: {e}"
        self.pragmas = self._collect_pragmas()

    def _collect_pragmas(self) -> Dict[int, Set[str]]:
        """1-indexed line -> rule ids allowed there. A pragma on a
        comment-only line also covers the next line (the idiomatic
        "justification comment above the statement" placement)."""
        out: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(line)
            if not m:
                continue
            ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
            out.setdefault(i, set()).update(ids)
            if line.lstrip().startswith("#"):
                out.setdefault(i + 1, set()).update(ids)
        return out

    def allowed(self, rule_id: str, line: int) -> bool:
        ids = self.pragmas.get(line, ())
        return rule_id in ids or "*" in ids


class RepoIndex:
    """Parsed view of the lintable files under a repo root.

    ``roots`` entries are files or directories relative to ``root``;
    missing ones are skipped (fixture mini-repos only ship the tree a
    rule needs). Rules address files through :meth:`matching` with
    repo-relative suffixes, so the same rule runs unchanged against the
    real repo and against a fixture tree that mimics the layout.
    """

    def __init__(self, root: str, roots: Sequence[str] = DEFAULT_ROOTS):
        self.root = os.path.abspath(root)
        self.files: List[ModuleSource] = []
        seen = set()
        for entry in roots:
            p = os.path.join(self.root, entry)
            if os.path.isfile(p) and p.endswith(".py"):
                self._add(p, seen)
            elif os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames if d not in _SKIP_DIRS
                    )
                    for f in sorted(filenames):
                        if f.endswith(".py"):
                            self._add(os.path.join(dirpath, f), seen)

    def _add(self, abspath: str, seen: set) -> None:
        abspath = os.path.abspath(abspath)
        if abspath in seen:
            return
        seen.add(abspath)
        rel = os.path.relpath(abspath, self.root).replace(os.sep, "/")
        self.files.append(ModuleSource(abspath, rel))

    def matching(self, *suffixes: str) -> List[ModuleSource]:
        """Files whose repo-relative path ends with any given suffix
        (``"blades_tpu_torch/telemetry/recorder.py"``, ...)."""
        out = []
        for mod in self.files:
            if any(
                mod.rel == s or mod.rel.endswith("/" + s.lstrip("/"))
                for s in suffixes
            ):
                out.append(mod)
        return out

    def under(self, prefix: str) -> List[ModuleSource]:
        """Files under a repo-relative directory prefix."""
        prefix = prefix.rstrip("/") + "/"
        return [m for m in self.files if m.rel.startswith(prefix)]

    def text(self, rel: str) -> Optional[str]:
        """Raw contents of an arbitrary repo file (e.g. a JSON schema),
        or None when absent."""
        p = os.path.join(self.root, rel)
        if not os.path.isfile(p):
            return None
        with open(p, encoding="utf-8") as f:
            return f.read()


class Rule:
    """Base class: subclasses set ``id``/``severity``/``rationale`` and
    implement :meth:`check`."""

    id: str = "RULE000"
    severity: str = "error"
    #: One sentence naming the incident that motivated the rule (judged
    #: prose: this is what justifies the lint's existence in review).
    rationale: str = ""

    def check(self, index: RepoIndex) -> List[Violation]:
        raise NotImplementedError

    # -- helpers shared by concrete rules -------------------------------------

    def violation(self, mod: ModuleSource, node_or_line, message: str) -> Violation:
        line = (
            node_or_line
            if isinstance(node_or_line, int)
            else getattr(node_or_line, "lineno", 0)
        )
        return Violation(rule=self.id, path=mod.rel, line=line, message=message)


def dotted_name(node: ast.AST) -> str:
    """``torch.from_numpy`` / ``torch.cuda.synchronize`` style dotted name
    of a Name/Attribute chain ('' when the expression is anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def run_rules(
    index: RepoIndex, rules: Sequence[Rule]
) -> Tuple[List[Violation], List[Violation]]:
    """Run every rule; returns ``(violations, pragma_waived)``.

    Unparseable files surface as a violation on every rule run (a syntax
    error must fail the gate, not silently shrink its coverage).
    """
    violations: List[Violation] = []
    waived: List[Violation] = []
    by_rel = {m.rel: m for m in index.files}
    for mod in index.files:
        if mod.parse_error:
            violations.append(
                Violation(
                    rule="PARSE000",
                    path=mod.rel,
                    line=0,
                    message=f"file does not parse: {mod.parse_error}",
                )
            )
    for rule in rules:
        for v in rule.check(index):
            mod = by_rel.get(v.path)
            if mod is not None and mod.allowed(v.rule, v.line):
                waived.append(v)
            else:
                violations.append(v)
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    waived.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations, waived
