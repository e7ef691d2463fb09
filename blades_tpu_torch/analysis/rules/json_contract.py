"""JSON001: the port's drivers with the one-JSON-line contract keep their
catch-all.

Counterpart: ``blades_tpu/analysis/rules/json_contract.py:57``
(``Json001``), copied; its ``CONTRACT_SCRIPTS`` (:29) bound to their
counterparts in the port where one exists. A caller (the certify matrix's
driver, the service's clients, this gate's own CI step) parses exactly
one JSON line from each of these; a traceback-only death with empty
stdout reads as a hung card. ``bench.py`` and ``scripts/perf_report.py``
have no counterpart in the port yet.

The rule, over the registered contract scripts: the module must define a
``main`` function whose body is wrapped in a top-level ``try`` with a
catch-all handler (``except Exception`` or bare ``except``; an ``except
SystemExit: raise`` sibling is the idiomatic argparse escape) that funnels
to a ``print(json.dumps(...))`` call — so every failure path still emits
the single final JSON line.
"""

from __future__ import annotations

import ast
from typing import List

from blades_tpu_torch.analysis.core import RepoIndex, Rule, Violation, dotted_name

#: Repo-relative suffixes of the scripts bound by the contract.
CONTRACT_SCRIPTS = (
    "blades_tpu_torch/examples/certify.py",  # scripts/certify.py
    "blades_tpu_torch/examples/runs.py",  # scripts/runs.py
    "blades_tpu_torch/examples/serve.py",  # scripts/serve.py
    "blades_tpu_torch/examples/sweep_status.py",  # scripts/sweep_status.py
    "blades_tpu_torch/analysis/__main__.py",  # blades_tpu/analysis/__main__.py
)


def _contains_json_print(node: ast.AST) -> bool:
    for call in ast.walk(node):
        if (
            isinstance(call, ast.Call)
            and dotted_name(call.func) == "print"
            and call.args
        ):
            for arg in ast.walk(call.args[0]):
                if (
                    isinstance(arg, ast.Call)
                    and dotted_name(arg.func) == "json.dumps"
                ):
                    return True
    return False


class Json001(Rule):
    id = "JSON001"
    severity = "error"
    rationale = (
        "Callers parse exactly one JSON line per driver; an unhandled "
        "exception means empty stdout, indistinguishable from a hung card "
        "(blades_tpu's bench.py contract; the port's examples/certify.py)."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        for mod in index.matching(*CONTRACT_SCRIPTS):
            if mod.tree is None:
                continue
            mains = [
                n
                for n in mod.tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main"
            ]
            if not mains:
                out.append(
                    self.violation(
                        mod,
                        1,
                        "contract script has no top-level `main()` to carry "
                        "the one-JSON-line catch-all",
                    )
                )
                continue
            main = mains[0]
            ok = False
            for stmt in main.body:
                if not isinstance(stmt, ast.Try):
                    continue
                for handler in stmt.handlers:
                    is_catch_all = handler.type is None or dotted_name(
                        handler.type
                    ) in ("Exception", "BaseException")
                    if is_catch_all and _contains_json_print(handler):
                        ok = True
            if not ok:
                out.append(
                    self.violation(
                        mod,
                        main,
                        "main() lacks a top-level try/except-Exception "
                        "funneling to print(json.dumps(...)): a failure "
                        "here reaches the driver as empty stdout instead "
                        "of one parseable error line",
                    )
                )
        return out
