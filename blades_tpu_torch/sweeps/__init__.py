"""Warm-engine reuse for sweeps that run many Simulators in one process.

Counterpart: ``blades_tpu/sweeps/__init__.py`` — ``static_fingerprint``,
``contains_callables`` and ``program_fingerprint`` (:77-187) and
``EngineCache`` (:342-423), with the ledger's ``config_fingerprint``
(``blades_tpu/telemetry/ledger.py:61-64``); the port keeps its own copies.
A :class:`EngineCache` maps a :func:`program_fingerprint` of an engine's
static configuration to the built ``RoundEngine``, so a run whose
configuration matches an earlier one reuses that engine and whatever it
holds warm: its captured CUDA graphs (``core/graphs.py``), where the JAX
package reuses its compiled programs. ``Simulator.run(engine_cache=...)``
builds the key (``blades_tpu/simulator.py:640-715``).

``static_fingerprint`` also collapses a ``torch.Tensor`` (through
``.cpu()``) the way it collapses an array. The JAX package reports an
eviction to its compile-provenance registry, which comes with slice 13
(``ROADMAP.md`` queue A); here it is counted in ``EngineCache.evictions``.
``SweepCell``, ``plan_groups`` and ``run_grouped`` belong to slice 13.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
import types
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "EngineCache",
    "config_fingerprint",
    "contains_callables",
    "program_fingerprint",
    "static_fingerprint",
]


def _hash_bytes(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()[:12]


def config_fingerprint(config: Dict[str, Any]) -> str:
    """Stable short hash of a canonical (JSON-serializable) config dict."""
    blob = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


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
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
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


class EngineCache:
    """Maps a :func:`program_fingerprint` to a built value (a
    ``RoundEngine``), with hit, miss and eviction counts and per-key stats;
    ``max_entries`` bounds it, evicting the least recently used entry
    (never the one just inserted)."""

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
