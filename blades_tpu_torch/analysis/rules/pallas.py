"""PAL001: every CUDA kernel of the port has a plain version, a launch
count, and no fallback that hides it.

Counterpart: ``blades_tpu/analysis/rules/pallas.py:51`` (``Pal001``), with
the opposite demand. On the TPU box, the Mosaic compile proxy rejected some
kernels, so the JAX rule demands an AOT probe with a plain-XLA fallback.
The port's contract is the reverse (``ROADMAP.md``, "Kernel shape"): on a
CUDA tensor the kernel runs or the call raises; the plain PyTorch version
serves CPU tensors and is the reference the kernel is held against on the
card; each wrapper counts its launches where it launches, so a card run
can prove its main path went through the kernel.

The rule, over ``blades_tpu_torch/ops/``, for each module that loads a
library through ``ops/_build.py`` (``_build.load`` / ``_build.build``;
the functions that do are its *loaders*, ``ops/trimmed.py:_library``):

- (a) each *launch function* (one that calls a loader and passes the
  current stream's ``cuda_stream``, ``ops/trimmed.py:trimmed_mean_cuda``)
  named ``<entry>_cuda`` has a plain version ``<entry>_plain`` in the
  module;
- (b) each launch function increments a module-level ``*_launches``
  counter (``global`` and ``+=``; ``ops/trimmed.py:63``, ``:153``, ``:173``);
- (c) no ``try`` around a launch or a library load has a handler that
  returns or calls a plain version (a fallback that hides the kernel);
- (d) every call of a plain version outside the plain versions themselves
  sits in the body of an ``if`` that tests a device's ``type`` against
  ``"cpu"``;

and every ``blades_tpu_torch/csrc/*.cu`` is loaded (``_build.load("<name>")``)
by some ``ops/`` module.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Set

from blades_tpu_torch.analysis.core import (
    ModuleSource,
    RepoIndex,
    Rule,
    Violation,
    dotted_name,
)

_LOADS = {"_build.load", "_build.build", "load", "build"}
_CSRC = "blades_tpu_torch/csrc"


def _calls(node: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)]


def _call_name(call: ast.Call) -> str:
    return dotted_name(call.func).rsplit(".", 1)[-1]


def _imports_build(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (
            (node.module or "").endswith("_build")
            or any(a.name == "_build" for a in node.names)
        ):
            return True
        if isinstance(node, ast.Import) and any(
                a.name.endswith("._build") for a in node.names):
            return True
    return False


def _is_cpu_test(test: ast.AST) -> bool:
    """The test holds ``<x>.type == "cpu"`` (the plain call must sit in
    the branch a CPU tensor takes)."""
    for node in ast.walk(test):
        if (
            isinstance(node, ast.Compare)
            and len(node.ops) == 1
            and isinstance(node.ops[0], ast.Eq)
        ):
            sides = [node.left, node.comparators[0]]
            if any(isinstance(s, ast.Constant) and s.value == "cpu" for s in sides) and any(
                isinstance(s, ast.Attribute) and s.attr == "type" for s in sides
            ):
                return True
    return False


class Pal001(Rule):
    id = "PAL001"
    severity = "error"
    rationale = (
        "No fallback may hide a kernel: on a CUDA tensor it runs or raises, "
        "its plain version serves the CPU and is its reference, and its "
        "launch count proves the card's main path ran it (ROADMAP.md "
        "'Kernel shape'; ops/trimmed.py)."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        loaded: Set[str] = set()
        for mod in index.under("blades_tpu_torch/ops"):
            if mod.tree is None:
                continue
            out.extend(self._check_module(mod, loaded))
        csrc = os.path.join(index.root, _CSRC)
        if os.path.isdir(csrc):
            for name in sorted(os.listdir(csrc)):
                if name.endswith(".cu") and name[:-3] not in loaded:
                    out.append(Violation(
                        rule=self.id, path=f"{_CSRC}/{name}", line=0,
                        message=f"CUDA source {name} is loaded by no ops/ module "
                        "(_build.load): a kernel with no wrapper has no plain "
                        "version, no launch count and no caller"))
        return out

    def _check_module(self, mod: ModuleSource, loaded: Set[str]) -> List[Violation]:
        if not _imports_build(mod.tree):
            return []
        fns: Dict[str, ast.FunctionDef] = {}
        parents: Dict[int, ast.AST] = {}
        for node in ast.walk(mod.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.setdefault(node.name, node)
        for c in _calls(mod.tree):
            if dotted_name(c.func) not in _LOADS:
                continue
            if c.args and isinstance(c.args[0], ast.Constant) and isinstance(
                    c.args[0].value, str):
                loaded.add(c.args[0].value)
        loaders = {name for name, fn in fns.items()
                   if any(dotted_name(c.func) in _LOADS for c in _calls(fn))}
        if not loaders:
            return []
        launches = {
            name for name, fn in fns.items()
            if name not in loaders
            and any(_call_name(c) in loaders for c in _calls(fn))
            and any(isinstance(n, ast.Attribute) and n.attr == "cuda_stream"
                    for n in ast.walk(fn))
        }
        plains = {name for name in fns if name.endswith("_plain")}
        out: List[Violation] = []

        for name in sorted(launches):
            fn = fns[name]
            # (a) a plain version of the entry
            entry = name[: -len("_cuda")] if name.endswith("_cuda") else name
            if f"{entry}_plain" not in plains:
                out.append(self.violation(
                    mod, fn, f"launch function `{name}` has no plain version "
                    f"`{entry}_plain` in its module: the CPU has no path and the card "
                    "no reference to hold the kernel against"))
            # (b) a module-level launch counter, incremented here
            declared = {g for n in ast.walk(fn) if isinstance(n, ast.Global) for g in n.names}
            counted = {
                n.target.id for n in ast.walk(fn)
                if isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Name)
                and isinstance(n.op, ast.Add) and n.target.id.endswith("_launches")
                and n.target.id in declared
            }
            if not counted:
                out.append(self.violation(
                    mod, fn, f"launch function `{name}` increments no module-level "
                    "`*_launches` counter: a card run cannot prove its main path "
                    "launched the kernel"))

        # (c) no fallback around a launch or a library load
        guarded = launches | loaders
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            body_calls = [c for stmt in node.body for c in _calls(stmt)]
            if not any(_call_name(c) in guarded or dotted_name(c.func) in _LOADS
                       for c in body_calls):
                continue
            for handler in node.handlers:
                hides = any(isinstance(n, ast.Return) for n in ast.walk(handler)) or any(
                    _call_name(c) in plains for c in _calls(handler))
                if hides:
                    out.append(self.violation(
                        mod, handler, "an `except` around a kernel launch or library "
                        "load returns or routes to the plain version: a fallback that "
                        "hides the kernel (on a CUDA tensor it runs or raises)"))

        # (d) the plain version only on a CPU device test
        for call in _calls(mod.tree):
            if _call_name(call) not in plains:
                continue
            node, inside, ok = call, None, False
            while id(node) in parents:
                parent = parents[id(node)]
                if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    inside = parent.name
                    break
                if isinstance(parent, ast.ExceptHandler):
                    ok = True  # a fallback in an `except` is (c)'s to report
                    break
                if isinstance(parent, ast.If) and node in parent.body and _is_cpu_test(
                        parent.test):
                    ok = True
                node = parent
            if ok or inside in plains:
                continue
            out.append(self.violation(
                mod, call, f"`{_call_name(call)}` called outside an `if <tensor>.device."
                "type == \"cpu\"` branch: the plain version serves CPU tensors only"))
        return out
