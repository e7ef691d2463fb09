"""Sweep serving: attack-search cells grouped by program shape, and
warm-engine reuse for sweeps that run many Simulators in one process.

Counterpart: ``blades_tpu/sweeps/__init__.py`` — ``static_fingerprint``,
``contains_callables`` and ``program_fingerprint`` (:77-187),
``SweepCell``, ``group_key``, ``plan_groups`` and ``run_grouped``
(:172-340) and ``EngineCache`` (:342-423); the port keeps its own copies.
``config_fingerprint`` lives in ``telemetry/ledger.py``, as in the JAX
package (``blades_tpu/telemetry/ledger.py:61-64``), and is re-exported
here.

**Cell grouping.** :func:`plan_groups` groups attack-search cells
(``examples/certify.py``) by :func:`group_key`: the defense's
configuration by value, the trial tensor's shape and dtype, the context's
keys and the presence of a participation mask, the JAX package's rule, so
a sweep groups its cells as the JAX package does. :func:`run_grouped` runs
each group through :func:`_execute_group`, one :func:`~blades_tpu_torch.
audit.attack_search.search_cells` call. There it amortizes one compile a
group; here it amortizes nothing but the one host read of a group's
deviations, and the results equal a cell-by-cell walk bit for bit. The
resilient executor (:mod:`.resilient`: retry, deadlines, bisection,
quarantine) re-enters the same :func:`_execute_group`, and :mod:`.journal`
keeps each finished cell for a resumed sweep.
A :class:`EngineCache` maps a :func:`program_fingerprint` of an engine's
static configuration to the built ``RoundEngine``, so a run whose
configuration matches an earlier one reuses that engine and whatever it
holds warm: its captured CUDA graphs (``core/graphs.py``), where the JAX
package reuses its compiled programs. ``Simulator.run(engine_cache=...)``
builds the key (``blades_tpu/simulator.py:640-715``).

``static_fingerprint`` also collapses a ``torch.Tensor`` (through
``.cpu()``) the way it collapses an array. The module imports neither
torch nor numpy at its top (a probe-only service imports it): a tensor is
recognised through ``sys.modules``, since a process that never imported
torch holds none. The JAX package reports an eviction to its
compile-provenance registry, which comes with slice 13b.2 (``ROADMAP.md``
queue A); here it is counted in ``EngineCache.evictions``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import time
import types
from typing import Any, Dict, List, Optional, Sequence, Tuple

from blades_tpu_torch.telemetry.ledger import config_fingerprint

__all__ = [
    "EngineCache",
    "SweepCell",
    "config_fingerprint",
    "contains_callables",
    "group_key",
    "plan_groups",
    "program_fingerprint",
    "run_grouped",
    "static_fingerprint",
]


def _hash_bytes(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()[:12]


def static_fingerprint(obj: Any, _depth: int = 0) -> Any:
    """A canonical, JSON-stable view of a config object's static content.

    Arrays and tensors collapse to ``(shape, dtype, content hash)``: equal
    values fingerprint equal. Objects with a ``static_fingerprint()``
    method (the fault model) supply their own view; dataclasses and plain
    objects decompose into their attributes (those starting with ``_``,
    caches and last-run records, are left out); functions, methods and
    classes fingerprint by qualified name (two closures of one function are
    not told apart: :func:`contains_callables` lets callers refuse them)."""
    if _depth > 8:
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    method = getattr(obj, "static_fingerprint", None)
    if callable(method) and not isinstance(obj, type):
        return {"__static__": type(obj).__name__, "view": method()}
    if isinstance(obj, dict):
        return {
            str(k): static_fingerprint(v, _depth + 1)
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))
        }
    if isinstance(obj, (list, tuple)):
        return [static_fingerprint(v, _depth + 1) for v in obj]
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        import numpy as np

        arr = np.asarray(obj)
        return {"__array__": [list(arr.shape), str(arr.dtype), _hash_bytes(arr.tobytes())]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            "__class__": type(obj).__name__,
            **{f.name: static_fingerprint(getattr(obj, f.name), _depth + 1)
               for f in dataclasses.fields(obj)},
        }
    # plain functions, methods and classes only: an instance defining
    # __call__ (every Aggregator) decomposes into its attributes below
    if isinstance(obj, (types.FunctionType, types.MethodType, types.BuiltinFunctionType,
                        type)):
        return {"__callable__": getattr(obj, "__qualname__", repr(obj))}
    attrs = getattr(obj, "__dict__", None)
    if attrs is not None:
        return {
            "__class__": type(obj).__name__,
            **{k: static_fingerprint(v, _depth + 1)
               for k, v in sorted(attrs.items()) if not k.startswith("_")},
        }
    return repr(obj)


def contains_callables(view: Any) -> bool:
    """True when a :func:`static_fingerprint` view holds a bare callable
    marker anywhere; a cache must not key on such a view, since two
    differently bound closures would fingerprint equal."""
    if isinstance(view, dict):
        return "__callable__" in view or any(contains_callables(v) for v in view.values())
    if isinstance(view, list):
        return any(contains_callables(v) for v in view)
    return False


def program_fingerprint(**parts: Any) -> str:
    """Short stable hash of a configuration's static view: the engine-cache
    key (the JAX package's, on the same parts)."""
    return config_fingerprint(static_fingerprint(parts))


# -- attack-search cell grouping ----------------------------------------------


@dataclasses.dataclass
class SweepCell:
    """One attack-search cell awaiting execution: ``agg`` (with the trial
    shape and the context's structure) sets its group; ``f``,
    ``part_mask``, ``ctx`` and ``trials`` are its data; ``payload`` rides
    along for the caller."""

    label: str
    agg: Any
    trials: Any
    f: int
    ctx: Dict[str, Any] = dataclasses.field(default_factory=dict)
    part_mask: Any = None
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


def group_key(cell: SweepCell) -> str:
    """The program-shape fingerprint of a cell: the defense's configuration
    by value, the ``[T, K, D]`` trial shape and dtype (the dtype's name
    without ``torch.``), the context's keys and whether a participation
    mask is given."""
    trials = cell.trials
    shape = tuple(trials.shape[-3:]) if trials.dim() == 3 else (1,) + tuple(trials.shape)
    return program_fingerprint(
        agg=cell.agg,
        trial_shape=list(shape),
        trial_dtype=str(trials.dtype).replace("torch.", ""),
        ctx_keys=sorted(cell.ctx or {}),
        has_part=cell.part_mask is not None,
    )


def plan_groups(cells: Sequence[SweepCell]) -> List[Tuple[str, List[int]]]:
    """Cell indices grouped by :func:`group_key`, groups in first-seen
    order, cells in input order within a group."""
    order: List[str] = []
    groups: Dict[str, List[int]] = {}
    for i, cell in enumerate(cells):
        key = group_key(cell)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    return [(key, groups[key]) for key in order]


def _execute_group(group: Sequence[SweepCell], key: str, *, grids: Optional[dict] = None):
    """One execution of ``group`` (cells sharing the program shape ``key``)
    through one ``search_cells`` call: the body :func:`run_grouped` and the
    resilient executor (``sweeps/resilient.py``) share, so a retry or a
    bisection half re-enters exactly the call that failed
    (``blades_tpu/sweeps/__init__.py:224-253``)."""
    from blades_tpu_torch.audit.attack_search import search_cells

    return search_cells(
        group[0].agg,
        [{"trials": c.trials, "f": c.f, "ctx": c.ctx, "part_mask": c.part_mask,
          "label": c.label} for c in group],
        grids=grids, batch_label=key,
    )


def run_grouped(cells: Sequence[SweepCell], *, grids: Optional[dict] = None, sweep=None,
                return_walls: bool = False):
    """The cells' search results in input order, each group through one
    :func:`_execute_group` (bit for bit what :func:`search_cell` gives each
    cell). ``sweep``: a ``telemetry.timeline.SweepAccounting``; each cell
    is recorded with its share of the group's wall and the shared
    ``batch`` key, and a failed group records every cell as failed before
    the error propagates. ``return_walls``: also return each cell's share
    of its group's wall."""
    from blades_tpu_torch.telemetry import recorder as _trecorder
    from blades_tpu_torch.telemetry.timeline import counter_delta

    cells = list(cells)
    results: List[Optional[Dict[str, Any]]] = [None] * len(cells)
    walls: List[float] = [0.0] * len(cells)
    for key, idxs in plan_groups(cells):
        group = [cells[i] for i in idxs]
        t0 = time.perf_counter()
        counters0 = _trecorder.process_counters()
        try:
            outs = _execute_group(group, key, grids=grids)
        except Exception as e:
            if sweep is not None:
                wall = time.perf_counter() - t0
                delta = counter_delta(counters0)
                for j, c in enumerate(group):
                    sweep.record(c.label, wall / len(group),
                                 counter_delta=delta if j == 0 else None, batch=key,
                                 batch_size=len(group), error=f"{type(e).__name__}: {e}",
                                 error_type=type(e).__name__)
            raise
        wall = time.perf_counter() - t0
        delta = counter_delta(counters0)
        exec_share = max(0.0, wall - delta.get("compile_s", 0.0)) / len(group)
        for i, out in zip(idxs, outs):
            results[i] = out
            walls[i] = wall / len(group)
        if sweep is not None:
            for j, c in enumerate(group):
                sweep.record(c.label, wall / len(group), counter_delta=delta if j == 0 else None,
                             execute_s=round(exec_share, 6), batch=key, batch_size=len(group))
    if return_walls:
        return results, walls
    return results


# -- warm engine cache ---------------------------------------------------------


class EngineCache:
    """Maps a :func:`program_fingerprint` to a built value (a
    ``RoundEngine``), with hit, miss and eviction counts and per-key stats;
    ``max_entries`` bounds it, evicting the least recently used entry
    (never the one just inserted). ``builds`` and ``build_s`` total the
    builds :meth:`put` was told of: the service's cold/warm accounting
    (``telemetry/reqpath.py:build_counters``) takes their deltas."""

    def __init__(self, max_entries: Optional[int] = None):
        self._entries: Dict[str, Any] = {}
        self._stats: Dict[str, Dict[str, Any]] = {}
        # LRU order by a use sequence: same-millisecond touches would make
        # an order by wall time arbitrary
        self._order: Dict[str, int] = {}
        self._seq = 0
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0
        self.build_s = 0.0

    def _touch(self, key: str) -> Dict[str, Any]:
        ks = self._stats.setdefault(
            key, {"hits": 0, "misses": 0, "build_s": None, "last_used": None})
        ks["last_used"] = round(time.time(), 3)
        self._seq += 1
        self._order[key] = self._seq
        return ks

    def get(self, key: str) -> Any:
        value = self._entries.get(key)
        ks = self._touch(key)
        if value is None:
            self.misses += 1
            ks["misses"] += 1
        else:
            self.hits += 1
            ks["hits"] += 1
        return value

    def put(self, key: str, value: Any, build_s: Optional[float] = None) -> None:
        self._entries[key] = value
        ks = self._touch(key)
        if build_s is not None:
            ks["build_s"] = round(float(build_s), 6)
            self.builds += 1
            self.build_s += float(build_s)
        if self.max_entries is not None and len(self._entries) > self.max_entries:
            victims = sorted((k for k in self._entries if k != key),
                             key=lambda k: self._order.get(k, 0))
            for victim in victims[: len(self._entries) - self.max_entries]:
                del self._entries[victim]
                self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "by_key": {k: dict(v) for k, v in self._stats.items()},
        }
