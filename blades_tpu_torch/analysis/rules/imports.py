"""IMP001 / IMP002: the torch-free import contract of the port's host-side
modules.

Counterpart: ``blades_tpu/analysis/rules/imports.py`` (``Imp001`` :156,
``Imp002`` :204, ``NO_JAX_SUFFIXES`` :34), restated for torch. The JAX
package keeps its telemetry, supervision, service and analysis modules
importable before jax; the port keeps their counterparts importable with
no torch in the process (a probe-only server, the pool's parent
and a worker before its first cell never load torch's library;
``tests/test_torch_isolation.py`` and ``tests/test_torch_workers.py`` prove
it at run time). One convenience import at module scope would break each
of them silently.

- **IMP001**: no module-scope ``import torch`` (or of another
  torch-importing package: ``torchvision``, ``triton``), nor of a port
  module that imports torch at module scope, in the contracted files.
  Which port modules import torch is computed from the tree: a module
  does when it, a package ``__init__`` on its dotted path, or a port
  module it imports at module scope does. Function-scope imports stay
  legal (lazy by construction).
- **IMP002**: ``blades_tpu_torch/telemetry/__init__.py`` must not import
  or re-export ``metric_pack`` / ``profiling`` at module scope.
"""

from __future__ import annotations

import ast
from typing import Container, Dict, List, Set

from blades_tpu_torch.analysis.core import RepoIndex, Rule, Violation

#: Files contracted to import without pulling in torch (module scope): the
#: counterparts of the JAX rule's ``NO_JAX_SUFFIXES``, every one of which
#: holds the contract in the port.
NO_TORCH_SUFFIXES = (
    "blades_tpu_torch/telemetry/__init__.py",
    "blades_tpu_torch/telemetry/recorder.py",
    "blades_tpu_torch/telemetry/schema.py",
    "blades_tpu_torch/telemetry/context.py",
    "blades_tpu_torch/telemetry/ledger.py",
    "blades_tpu_torch/telemetry/alerts.py",
    "blades_tpu_torch/telemetry/timeline.py",
    "blades_tpu_torch/telemetry/reqpath.py",
    "blades_tpu_torch/telemetry/programs.py",
    "blades_tpu_torch/supervision/__init__.py",
    "blades_tpu_torch/supervision/__main__.py",
    "blades_tpu_torch/supervision/heartbeat.py",
    "blades_tpu_torch/supervision/supervisor.py",
    "blades_tpu_torch/analysis/__init__.py",
    "blades_tpu_torch/analysis/__main__.py",
    "blades_tpu_torch/analysis/core.py",
    "blades_tpu_torch/analysis/rules/__init__.py",
    "blades_tpu_torch/analysis/rules/aliasing.py",
    "blades_tpu_torch/analysis/rules/citations.py",
    "blades_tpu_torch/analysis/rules/host_sync.py",
    "blades_tpu_torch/analysis/rules/imports.py",
    "blades_tpu_torch/analysis/rules/json_contract.py",
    "blades_tpu_torch/analysis/rules/pallas.py",
    "blades_tpu_torch/analysis/rules/schema_drift.py",
    "blades_tpu_torch/analysis/rules/telemetry_io.py",
    "blades_tpu_torch/analysis/rules/xla_flags.py",
    "blades_tpu_torch/service/__init__.py",
    "blades_tpu_torch/service/protocol.py",
    "blades_tpu_torch/service/client.py",
    "blades_tpu_torch/service/spool.py",
    "blades_tpu_torch/service/server.py",
    "blades_tpu_torch/service/scheduler.py",
    "blades_tpu_torch/service/workers.py",
    "blades_tpu_torch/service/worker.py",
    # the port's own: the sweep layer a probe-only server and
    # the certify driver's journal read before any cell runs
    "blades_tpu_torch/sweeps/__init__.py",
    "blades_tpu_torch/sweeps/journal.py",
    "blades_tpu_torch/sweeps/resilient.py",
    "blades_tpu_torch/utils/retry.py",
    # the port's own: the run-record readers and the LEAF tools, which read
    # a live run's files beside it
    "blades_tpu_torch/examples/trace_summary.py",
    "blades_tpu_torch/examples/runs.py",
    "blades_tpu_torch/examples/sweep_status.py",
    "blades_tpu_torch/leaf/__init__.py",
    "blades_tpu_torch/leaf/util.py",
    "blades_tpu_torch/leaf/sample.py",
    "blades_tpu_torch/leaf/split_data.py",
    "blades_tpu_torch/leaf/stats.py",
    "blades_tpu_torch/leaf/remove_users.py",
    "blades_tpu_torch/leaf/preprocess.py",
    "blades_tpu_torch/leaf/download.py",
)

#: Packages outside the port that load torch's library.
TORCH_PACKAGES = ("torch", "torchvision", "triton")

_PORT = "blades_tpu_torch"


def _package_of(rel: str) -> str:
    """Dotted package containing a repo-relative file (``a/b/c.py`` and
    ``a/b/__init__.py`` both → ``a.b``) — the base for resolving relative
    imports."""
    return rel.rsplit("/", 1)[0].replace("/", ".") if "/" in rel else ""


def _resolve_relative(package: str, level: int, module) -> str:
    """Absolute dotted name of a ``from .[module] import ...`` target, or
    '' when the relative import escapes the known package."""
    parts = package.split(".") if package else []
    if level - 1 > len(parts):
        return ""
    if level > 1:
        parts = parts[: len(parts) - (level - 1)]
    return ".".join(parts + (module.split(".") if module else []))


def _module_scope_imports(tree: ast.Module, package: str = ""):
    """(node, module_name) for every import at module scope — including
    inside module-level ``if``/``try``/``with`` blocks, which still execute
    at import time — but NOT inside function/class-method bodies.

    Relative imports resolve against ``package``, and from-imports yield
    ``module.alias`` for each name too: ``from blades_tpu_torch.telemetry
    import metric_pack`` loads the torch-importing submodule even though
    its module path alone looks clean."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = (
                _resolve_relative(package, node.level, node.module)
                if node.level
                else (node.module or "")
            )
            if base:
                yield node, base
                for alias in node.names:
                    if alias.name != "*":
                        yield node, f"{base}.{alias.name}"
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                for child in getattr(node, field, []):
                    if isinstance(child, ast.ExceptHandler):
                        todo.extend(child.body)
                    else:
                        todo.append(child)


def _is_or_under(name: str, root: str) -> bool:
    return name == root or name.startswith(root + ".")


def _dotted(rel: str) -> str:
    """``blades_tpu_torch/a/b.py`` → ``blades_tpu_torch.a.b``;
    ``.../__init__.py`` → its package."""
    mod = rel[:-3] if rel.endswith(".py") else rel
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


def _executed(name: str, modules: Container[str]) -> List[str]:
    """The port modules that importing ``name`` runs: every package on its
    dotted path, and the module itself (for ``pkg.mod.attr``, the longest
    prefix that is a module)."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(1, len(parts) + 1)
            if ".".join(parts[:i]) in modules]


def torch_importing_modules(index: RepoIndex) -> Dict[str, str]:
    """Port module (dotted) -> the torch package it loads at module scope,
    directly or through the port modules it imports."""
    modules = {_dotted(m.rel): m for m in index.under(_PORT) if m.tree is not None}
    deps: Dict[str, Set[str]] = {}
    bad: Dict[str, str] = {}
    for name, mod in modules.items():
        deps[name] = set(_executed(name, modules)) - {name}
        for _, imported in _module_scope_imports(mod.tree, _package_of(mod.rel)):
            root = next((r for r in TORCH_PACKAGES if _is_or_under(imported, r)), None)
            if root is not None:
                bad.setdefault(name, root)
            deps[name].update(_executed(imported, modules))
    changed = True
    while changed:
        changed = False
        for name, ds in deps.items():
            if name in bad:
                continue
            hit = next((d for d in sorted(ds) if d in bad), None)
            if hit is not None:
                bad[name] = bad[hit]
                changed = True
    return bad


class Imp001(Rule):
    id = "IMP001"
    severity = "error"
    rationale = (
        "A probe-only server, the pool's parent and the ledger/journal/"
        "supervisor tooling run with no torch in the process ("
        "tests/test_torch_isolation.py); one module-scope import breaks them."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        torchy = torch_importing_modules(index)
        modules = {_dotted(m.rel) for m in index.under(_PORT) if m.tree is not None}
        for mod in index.matching(*NO_TORCH_SUFFIXES):
            if mod.tree is None:
                continue
            is_telemetry_init = mod.rel.endswith(Imp002._INIT_SUFFIX)
            seen = set()  # one `from x import a, b` yields x, x.a, x.b —
            # report each (line, offending module) once
            for node, name in _module_scope_imports(
                mod.tree, _package_of(mod.rel)
            ):
                bad = next((r for r in TORCH_PACKAGES if _is_or_under(name, r)), None)
                via = None
                if bad is None:
                    hit = next((m for m in _executed(name, modules)
                                if m in torchy and m != _dotted(mod.rel)), None)
                    if hit is None:
                        continue
                    bad, via = torchy[hit], hit
                if is_telemetry_init and via is not None and _is_or_under(
                        via, f"{_PORT}.telemetry"):
                    # IMP002 owns the submodule-only discipline of the
                    # telemetry __init__ — one rule per incident
                    continue
                key = (getattr(node, "lineno", 0), via or bad)
                if key in seen:
                    continue
                seen.add(key)
                pulled = bad if via is None else f"{via}, which imports {bad}"
                out.append(
                    self.violation(
                        mod,
                        node,
                        f"module-scope import of {name!r} in a file "
                        "contracted to import with no torch "
                        f"(pulls in {pulled}); import it inside the "
                        "function that needs it",
                    )
                )
        return out


class Imp002(Rule):
    id = "IMP002"
    severity = "error"
    rationale = (
        "metric_pack/profiling import torch; re-exporting them from "
        "blades_tpu_torch.telemetry would load torch in every torch-free "
        "consumer of the recorder (telemetry/__init__.py's import discipline)."
    )

    _INIT_SUFFIX = "blades_tpu_torch/telemetry/__init__.py"
    _SUBMODULE_ONLY = ("metric_pack", "profiling")

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        for mod in index.matching(self._INIT_SUFFIX):
            if mod.tree is None:
                continue
            seen = set()

            def add(node, leaf):
                key = (getattr(node, "lineno", 0), leaf)
                if key in seen:
                    return
                seen.add(key)
                out.append(
                    self.violation(
                        mod,
                        node,
                        f"telemetry/__init__ imports torch-importing "
                        f"submodule {leaf!r}; it must stay "
                        "submodule-only (import blades_tpu_torch.telemetry."
                        f"{leaf} at the use site)",
                    )
                )

            for node, name in _module_scope_imports(
                mod.tree, _package_of(mod.rel)
            ):
                leaf = name.rsplit(".", 1)[-1]
                if leaf in self._SUBMODULE_ONLY and "telemetry" in name:
                    add(node, leaf)
            # re-export at ANY scope (a function-level re-export is still
            # __init__ API surface) — absolute or relative spelling
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ImportFrom):
                    continue
                if node.level == 1 and node.module in self._SUBMODULE_ONLY:
                    add(node, node.module)  # `from .metric_pack import f`
                    continue
                from_telemetry = (
                    node.module and node.module.endswith("telemetry")
                ) or (node.level == 1 and not node.module)
                if from_telemetry:
                    for alias in node.names:
                        if alias.name in self._SUBMODULE_ONLY:
                            add(node, alias.name)
        return out
