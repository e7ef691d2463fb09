"""SYNC001: no host sync in code reachable from the round body.

Counterpart: ``blades_tpu/analysis/rules/host_sync.py:153`` (``Sync001``),
whose module-local call graph this rule keeps. There, a host sync inside a
traced body breaks ``jax.jit`` or costs a device round trip per call. In
the port a round is eager PyTorch, captured as a CUDA graph on the card
(``core/graphs.py``), and the same calls cost more: a host read inside the
round body waits for the card's queue to drain (the dispatch floor the
JAX package measured at 2.7x from scheduling alone), and inside a
capture it raises (``RoundGraph._capture`` runs the body under
``torch.cuda.set_sync_debug_mode("error")``).

Mechanics: within each module of the device-code surface (``core/engine.py``,
``core/batched.py``, ``core/graphs.py``, ``ops/``, ``aggregators/``,
``attackers/``, ``faults/``, ``audit/``, ``asyncfl/``) the rule builds a
module-local call graph. **Roots** are

- the cross-module protocol methods the engine calls by name inside the
  round (JAX's list: ``aggregate*``, ``diagnostics``, ``streaming_*``,
  ``on_updates*``, ``apply``, ``corrupt_chunk``, ``plan_streaming``,
  ``async_round``, ``draw``, ``staleness_mask_weights``; and the port's
  ``on_grads`` / ``on_batch``, which run inside local training);
- functions and lambdas handed to ``torch.func.vmap`` / ``grad_and_value``
  / ``grad`` / ``vjp`` / ``functional_call`` (a name bound in the module to
  an expression that names a def counts as that def), and every function
  called inside a ``with torch.cuda.graph(...)`` block;
- the engine's round bodies: ``RoundEngine._round``, ``RoundGraph._body``,
  ``core/batched.py:run_batched``.

Reachability then propagates through same-module references (``self._helper``,
bare names, nested defs). Banned inside reachable bodies:

- ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``;
- ``torch.cuda.synchronize()``;
- ``float(...)`` / ``int(...)`` / ``bool(...)`` of a torch expression (a
  ``torch.*`` call, or a local assigned from one, or a method, attribute or
  index of either, but not its ``shape`` / ``dtype`` / ``device`` / ``numel``
  / ``dim`` / ``size``), and an ``if`` / ``while`` whose test is one (its
  truth value is a ``bool``);
- ``time.*`` calls (a host clock inside a captured body is read once, at
  capture).

The port's documented host syncs (GeoMed's and AutoGM's stopping rule on
the host, ``ROADMAP.md`` queue B, item 7c) carry a pragma on the line.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from blades_tpu_torch.analysis.core import (
    ModuleSource,
    RepoIndex,
    Rule,
    Violation,
    dotted_name,
)

#: Repo-relative prefixes/files forming the device-code surface.
DEVICE_SCOPES = (
    "blades_tpu_torch/core/engine",
    "blades_tpu_torch/core/batched",
    "blades_tpu_torch/core/graphs",
    "blades_tpu_torch/ops",
    "blades_tpu_torch/aggregators",
    "blades_tpu_torch/attackers",
    "blades_tpu_torch/faults",
    "blades_tpu_torch/audit",
    "blades_tpu_torch/asyncfl",
)

#: torch's function transforms: every function-valued argument is a root
_FN_CONSUMERS = {
    "vmap", "torch.vmap", "torch.func.vmap", "func.vmap",
    "grad_and_value", "torch.func.grad_and_value", "func.grad_and_value",
    "grad", "torch.func.grad", "func.grad",
    "vjp", "torch.func.vjp", "func.vjp",
    "functional_call", "torch.func.functional_call", "func.functional_call",
}
#: context managers whose body is captured into a CUDA graph
_CAPTURES = {"torch.cuda.graph", "cuda.graph"}
#: Methods the engine calls in OTHER modules by name inside the round (the
#: cross-module edges a module-local call graph cannot see): JAX's list
#: (``blades_tpu/analysis/rules/host_sync.py:82``) and the attack's hooks
#: inside local training.
PROTOCOL_ROOTS = {
    "aggregate",
    "aggregate_masked",
    "_masked_aggregate",
    "aggregate_with_diagnostics",
    "aggregate_masked_with_diagnostics",
    "aggregate_masked_batched",
    "diagnostics",
    "streaming_init",
    "streaming_update",
    "streaming_finalize",
    "streaming_apply",
    "on_updates",
    "on_updates_batched",
    "apply",
    "corrupt_chunk",
    "plan_streaming",
    "async_round",
    "draw",
    "staleness_mask_weights",
    # the port's: the attack's hooks, called per local step
    "on_grads",
    "on_batch",
}
#: the engine's round bodies (eager, and captured on the card)
ROUND_BODIES = {"_round", "_body", "run_batched"}

_BANNED_CALLS = {
    "torch.cuda.synchronize": "waits for the card inside the round body",
}
_BANNED_METHODS = {
    ".item": "blocking device->host read",
    ".tolist": "blocking device->host read",
    ".cpu": "device->host copy",
    ".numpy": "host materialization of a tensor",
}
#: attributes / methods of a tensor that are host metadata, not a read
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "numel", "dim", "size",
                 "is_cuda", "requires_grad", "layout", "names"}
#: torch functions answering from the host, not from a tensor's values
_STATIC_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.is_", "torch.get_",
                          "torch.are_", "torch.finfo", "torch.iinfo", "torch.Size",
                          "torch.device", "torch.dtype", "torch.promote_types",
                          "torch.result_type", "torch.compiler.")


class _Fn:
    __slots__ = ("node", "name", "reachable", "transformed")

    def __init__(self, node: ast.AST, name: str):
        self.node = node
        self.name = name
        self.reachable = False
        # handed to a torch.func transform: its arguments are tensors
        self.transformed = False


def _own_statements(fn: ast.AST):
    """Walk a function (or lambda) body, NOT descending into nested
    function/class defs or lambdas (those are separate graph nodes)."""
    todo = [fn.body] if isinstance(fn, ast.Lambda) else list(fn.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                             ast.Lambda)):
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


def _refs(node: ast.AST) -> Set[str]:
    """Every bare name and attribute name an expression mentions (over-
    marking is harmless: a name only matters where a def carries it)."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _torch_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name.split(".", 1)[0] == "torch" and not name.startswith(_STATIC_TORCH_PREFIXES)


def _is_torch_expr(node: ast.AST, traced: Set[str]) -> bool:
    """True where ``node`` evaluates to a tensor's values as far as the
    source shows: a torch call, a local assigned from one, or a method,
    index, arithmetic or comparison of either (not host metadata)."""
    if isinstance(node, ast.Name):
        return node.id in traced
    if isinstance(node, ast.Call):
        if _torch_call(node):
            return True
        f = node.func
        if isinstance(f, ast.Attribute):
            return f.attr not in _STATIC_ATTRS and _is_torch_expr(f.value, traced)
        return False
    if isinstance(node, ast.Attribute):
        return node.attr not in _STATIC_ATTRS and _is_torch_expr(node.value, traced)
    if isinstance(node, ast.Subscript):
        return _is_torch_expr(node.value, traced)
    if isinstance(node, ast.BinOp):
        return _is_torch_expr(node.left, traced) or _is_torch_expr(node.right, traced)
    if isinstance(node, ast.UnaryOp):
        return _is_torch_expr(node.operand, traced)
    if isinstance(node, ast.BoolOp):
        return any(_is_torch_expr(v, traced) for v in node.values)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
            return False
        return any(_is_torch_expr(v, traced) for v in [node.left, *node.comparators])
    return False


class Sync001(Rule):
    id = "SYNC001"
    severity = "error"
    rationale = (
        "A host read in the round body drains the card's queue every call "
        "(the dispatch floor blades_tpu measured at 2.7x) and raises "
        "inside a CUDA-graph capture (core/graphs.py:RoundGraph._capture)."
    )

    def check(self, index: RepoIndex) -> List[Violation]:
        out: List[Violation] = []
        mods: List[ModuleSource] = []
        for scope in DEVICE_SCOPES:
            mods.extend(index.under(scope))
            mods.extend(index.matching(scope + ".py"))
        seen = set()
        for mod in mods:
            if mod.rel in seen or mod.tree is None:
                continue
            seen.add(mod.rel)
            out.extend(self._check_module(mod))
        return out

    # -- per-module analysis ---------------------------------------------------

    def _check_module(self, mod: ModuleSource) -> List[Violation]:
        fns: List[_Fn] = []
        by_name: Dict[str, List[_Fn]] = {}
        bindings: Dict[str, Set[str]] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = _Fn(node, node.name)
                fns.append(fn)
                by_name.setdefault(node.name, []).append(fn)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, (ast.Name, ast.Attribute)):
                        key = t.id if isinstance(t, ast.Name) else t.attr
                        bindings.setdefault(key, set()).update(_refs(node.value))

        # roots: transform-consumed functions, captured bodies, protocol
        # methods and the round bodies
        root_names: Set[str] = set()

        def mark(expr: ast.AST, transform: bool = False) -> None:
            for n in ast.walk(expr):
                if isinstance(n, ast.Lambda):
                    fn = _Fn(n, "<lambda>")
                    fn.reachable = fn.transformed = transform
                    fns.append(fn)
            names = _refs(expr)
            # a name bound in the module to an expression naming a def
            for name in list(names):
                names |= bindings.get(name, set())
            root_names.update(names)
            if transform and not isinstance(expr, ast.Lambda):
                # the function handed over itself (a lambda's callees are
                # only reachable: their arguments need not be tensors)
                transformed.update(names)

        transformed: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and dotted_name(node.func) in _FN_CONSUMERS:
                for arg in node.args:
                    mark(arg, transform=True)
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and dotted_name(item.context_expr.func) in _CAPTURES
                for item in node.items
            ):
                for stmt in node.body:
                    mark(stmt)
        for fn in fns:
            if fn.name in PROTOCOL_ROOTS or fn.name in ROUND_BODIES:
                root_names.add(fn.name)
        for fn in fns:
            if fn.name in root_names:
                fn.reachable = True
            if fn.name in transformed:
                fn.transformed = True

        # propagate: any identifier referenced in a reachable body that
        # names a same-module def marks that def reachable
        changed = True
        while changed:
            changed = False
            for fn in fns:
                if not fn.reachable:
                    continue
                for node in _own_statements(fn.node):
                    ref = None
                    if isinstance(node, ast.Name):
                        ref = node.id
                    elif isinstance(node, ast.Attribute):
                        ref = node.attr
                    if ref and ref in by_name:
                        for target in by_name[ref]:
                            if not target.reachable:
                                target.reachable = True
                                changed = True

        out: List[Violation] = []
        for fn in fns:
            if fn.reachable:
                out.extend(self._check_body(mod, fn))
        return out

    @staticmethod
    def _traced_locals(fn: _Fn) -> Dict[str, int]:
        """Locals assigned from a torch expression (to a fixpoint), each
        with the line of its first such assignment: a use on or before
        that line reads the value it had before (``x = torch.full((),
        int(x))`` reads a host ``x``)."""
        traced: Dict[str, int] = {}
        if fn.transformed:
            args = fn.node.args
            traced.update({a.arg: 0 for a in args.posonlyargs + args.args + args.kwonlyargs})
        for _ in range(3):
            for node in _own_statements(fn.node):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    value = node.value
                    if value is None or not _is_torch_expr(value, set(traced)):
                        continue
                    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                    names = []
                    for t in targets:
                        if isinstance(t, ast.Name):
                            names.append(t.id)
                        elif isinstance(t, (ast.Tuple, ast.List)):
                            names.extend(e.id for e in t.elts if isinstance(e, ast.Name))
                    for name in names:
                        traced[name] = min(traced.get(name, node.lineno), node.lineno)
        return traced

    def _check_body(self, mod: ModuleSource, fn: _Fn) -> List[Violation]:
        out: List[Violation] = []
        first = self._traced_locals(fn)
        where = f"round-reachable `{fn.name}`"
        for node in _own_statements(fn.node):
            line = getattr(node, "lineno", 0)
            traced = {n for n, at in first.items() if at < line}
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                why = _BANNED_CALLS.get(name)
                if why is None and name.startswith("time."):
                    why = "host clock inside the round body (read once, at capture)"
                if why is not None:
                    out.append(self.violation(
                        mod, node, f"{name}() in {where}: {why} (a host sync in the "
                        "round; it raises inside a CUDA-graph capture)"))
                    continue
                if isinstance(node.func, ast.Attribute):
                    why = _BANNED_METHODS.get("." + node.func.attr)
                    if why is not None:
                        out.append(self.violation(
                            mod, node, f"`.{node.func.attr}()` in {where}: {why}"))
                        continue
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and node.args
                    and _is_torch_expr(node.args[0], traced)
                ):
                    out.append(self.violation(
                        mod, node, f"{node.func.id}(<tensor>) in {where}: reads a "
                        "tensor's value on the host (a host sync)"))
            elif isinstance(node, (ast.If, ast.While, ast.IfExp)) and _is_torch_expr(
                    node.test, traced):
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "if-expression"}[
                    type(node)]
                out.append(self.violation(
                    mod, node, f"Python `{kind}` on a tensor in {where}: its truth "
                    "value is a host read; use torch.where"))
        return out
