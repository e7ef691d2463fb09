"""ALIAS001: no zero-copy tensor built from an ``np.load`` archive.

Counterpart: ``blades_tpu/analysis/rules/aliasing.py:41`` (``Alias001``),
restated for torch. The JAX package once resumed rounds from heap
garbage: ``jnp.asarray`` aliased the npz buffer into a donated program
input while numpy freed the real owner. The port's captured round writes
its state back into static buffers in place (``core/graphs.py:write_back``)
and restores a checkpoint into them (``utils/checkpoint.py``), so a tensor
that still views an archive's buffer is the same hazard:
``torch.from_numpy`` and ``torch.as_tensor`` share the numpy array's memory
on the CPU.

The rule: inside any function that calls ``np.load``/``numpy.load``, a
value derived from the loaded archive must never be wrapped with
``torch.from_numpy(...)`` / ``torch.as_tensor(...)`` unless the argument is
itself a copy (``np.array(..., copy=True)``, ``np.copy(...)``,
``<x>.copy()``) or the result is ``.clone()``-d at once —
``utils/checkpoint.py:104`` copies, so the rule stays silent there.
"""

from __future__ import annotations

import ast
from typing import List, Set

from blades_tpu_torch.analysis.core import (
    ModuleSource,
    RepoIndex,
    Rule,
    Violation,
    dotted_name,
)

_LOADERS = {"np.load", "numpy.load", "onp.load"}
_WRAPPERS = {"torch.from_numpy", "torch.as_tensor"}


def _referenced_names(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class Alias001(Rule):
    id = "ALIAS001"
    severity = "error"
    rationale = (
        "blades_tpu's resume corruption: a zero-copy view of an npz "
        "buffer in state the round writes in place; the port's graphs write "
        "their state back in place (core/graphs.py:write_back)."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        # nested defs are walked both standalone and via their enclosing
        # function (the enclosing walk is what carries closure taint into
        # them), so identical findings are deduped rather than re-reported
        out: List[Violation] = []
        seen = set()
        for mod in index.files:
            if mod.tree is None:
                continue
            for fn in ast.walk(mod.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for v in self._check_function(mod, fn):
                        key = (v.path, v.line, v.message)
                        if key not in seen:
                            seen.add(key)
                            out.append(v)
        return out

    @staticmethod
    def _bind(target: ast.AST, tainted: Set[str]) -> None:
        if isinstance(target, ast.Name):
            tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            tainted.update(
                e.id for e in target.elts if isinstance(e, ast.Name)
            )

    def _check_function(self, mod: ModuleSource, fn: ast.AST) -> List[Violation]:
        # pass 1: names bound to an npz archive, then (transitively, two
        # sweeps) names bound to members/derivations of one. Bindings via
        # plain/annotated assignment, walrus, and `with np.load(..) as z:`
        # (the documented numpy idiom) all taint.
        tainted: Set[str] = set()
        for _ in range(3):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and node.targets:
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.NamedExpr):
                    targets, value = [node.target], node.value
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if item.optional_vars is None:
                            continue
                        v = item.context_expr
                        if (
                            isinstance(v, ast.Call)
                            and dotted_name(v.func) in _LOADERS
                        ) or (_referenced_names(v) & tainted):
                            self._bind(item.optional_vars, tainted)
                    continue
                else:
                    continue
                is_load = (
                    isinstance(value, ast.Call)
                    and dotted_name(value.func) in _LOADERS
                )
                derives = bool(_referenced_names(value) & tainted)
                if is_load or derives:
                    for t in targets:
                        self._bind(t, tainted)
        if not tainted:
            return []
        out: List[Violation] = []
        cloned = {
            id(n.func.value)
            for n in ast.walk(fn)
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "clone"
        }
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call):
                continue
            name = dotted_name(call.func)
            if name not in _WRAPPERS or not call.args:
                continue
            if not (_referenced_names(call.args[0]) & tainted):
                continue
            if _is_copy(call.args[0]) or id(call) in cloned:
                continue
            out.append(
                self.violation(
                    mod,
                    call,
                    f"{name}(...) on an npz-loaded value shares the numpy "
                    "buffer: a state the round writes back in place would "
                    "view the archive (blades_tpu's resume corruption) — "
                    "copy first: torch.from_numpy(np.array(..., copy=True))",
                )
            )
        return out


def _is_copy(node: ast.AST) -> bool:
    """``np.array(x, copy=True)``, ``np.copy(x)`` or ``x.copy()``."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name in ("np.copy", "numpy.copy") or (
        isinstance(node.func, ast.Attribute) and node.func.attr == "copy" and not node.args
    ):
        return True
    return name in ("np.array", "numpy.array") and any(
        kw.arg == "copy"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in node.keywords
    )
