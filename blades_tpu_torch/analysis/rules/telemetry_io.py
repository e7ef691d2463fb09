"""TEL001: the telemetry recorder writes only when it flushes.

Counterpart: ``blades_tpu/analysis/rules/telemetry_io.py:36`` (``Tel001``),
copied. The recorder lives inside the round loop; a syscall per span (an
``open``/``write``/``flush`` in ``_emit`` or the span's exit path) takes
host time from the dispatch of the card's work, and the heartbeat windows
of the supervisor (``supervision/``) read the same clock. The recorder's contract is
therefore *buffered*: records accumulate in memory and
:meth:`~blades_tpu_torch.telemetry.recorder.Recorder.flush` writes the
pending batch as one buffered write at round boundaries.

The rule, over ``blades_tpu_torch/telemetry/recorder.py``: outside the
designated sink methods (``flush`` / ``close``), no call to ``open()``,
``.write()`` / ``.writelines()``, ``.flush()``, ``os.fsync``, or
``print(..., file=...)`` — i.e. the record/span/counter paths may only
append to the in-memory buffer.
"""

from __future__ import annotations

import ast
from typing import List

from blades_tpu_torch.analysis.core import RepoIndex, Rule, Violation, dotted_name

_SINK_METHODS = {"flush", "close"}
_IO_CALLS = {"open", "os.fsync"}
_IO_METHODS = {".write", ".writelines", ".flush"}


class Tel001(Rule):
    id = "TEL001"
    severity = "error"
    rationale = (
        "Per-span I/O in the recorder takes host time from the round's "
        "dispatch and the heartbeat windows; flush-once-per-round is the "
        "recorder's contract (telemetry/recorder.py:flush)."
    )

    @staticmethod
    def _own_calls(fn: ast.AST):
        """Call nodes belonging to ``fn``'s own body, NOT descending into
        nested defs (each nested def is visited as its own function —
        ``ast.walk`` can't prune subtrees, so this walks by hand)."""
        todo = list(fn.body)
        while todo:
            node = todo.pop(0)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Call):
                yield node
            todo.extend(ast.iter_child_nodes(node))

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        for mod in index.matching("blades_tpu_torch/telemetry/recorder.py"):
            if mod.tree is None:
                continue
            # a helper nested inside flush/close IS the sanctioned sink
            # path — collect those defs so they aren't flagged under
            # their own (non-sink) names
            sanctioned = set()
            for fn in ast.walk(mod.tree):
                if (
                    isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and fn.name in _SINK_METHODS
                ):
                    sanctioned.update(
                        id(n)
                        for n in ast.walk(fn)
                        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    )
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if fn.name in _SINK_METHODS or id(fn) in sanctioned:
                    continue
                for node in self._own_calls(fn):
                    name = dotted_name(node.func)
                    is_print_to_file = name == "print" and any(
                        kw.arg == "file" for kw in node.keywords
                    )
                    if (
                        name in _IO_CALLS
                        or any(name.endswith(m) for m in _IO_METHODS)
                        or is_print_to_file
                    ):
                        out.append(
                            self.violation(
                                mod,
                                node,
                                f"sink I/O call `{name}` in recorder method "
                                f"`{fn.name}` (outside flush/close): the "
                                "recorder must buffer in memory and write "
                                "once per round — per-span I/O takes host "
                                "time from the round's dispatch",
                            )
                        )
        return out
