"""Build provenance: attribute every kernel build, kernel-library load and
CUDA-graph capture to a program, a cause and a cache outcome.

Counterpart: ``blades_tpu/telemetry/programs.py`` (``watch``,
``_classify_cause``, ``_close``, ``note_eviction``, ``events``,
``snapshot``, ``reset``, the bounded ledger and the ``unattributed``
bucket), copied. The JAX registry observes XLA's trace, lower and compile
events; the port compiles no XLA program, so this one observes the
port's build counters instead (``telemetry/recorder.py:count_process``,
through :func:`~blades_tpu_torch.telemetry.recorder.add_counter_observer`).
The ``program`` record keeps the shared schema (``telemetry_schema.json``
v9, ``"extra": false``); the port's counters map onto its fields so:

============== =====================================================
record field   port counter
============== =====================================================
``compile_s``  ``cuda.kernel_build_s`` (``nvcc``, ``ops/_build.py``)
``trace_s``    ``cuda.graph_capture_s`` (``core/graphs.py``)
``compiles``   ``cuda.kernel_builds`` + ``cuda.graph_captures``
``cache_hits`` ``cuda.kernel_reuses`` (a library up to date on disk)
============== =====================================================

``lower_s`` and ``cache_misses`` have no counterpart and never appear.

**How attribution works.** Each increment of a mapped counter goes to
the innermost open :func:`watch` scope on the calling thread, or, with
none open, to the ``unattributed`` bucket; so attributed plus
unattributed seconds equal the process mirror's (the tiling invariant).
The call sites: the model's init and ``engine/construct``
(``simulator.py``), ``RoundEngine._provenance`` around ``init``,
``run_round``, ``run_block`` and the evaluation (``core/engine.py``), the
sampler (``datasets/fl.py``) and the attack search
(``audit/attack_search.py``); ``EngineCache`` reports its evictions
(:func:`note_eviction`).

**What a close emits.** Its outcome:

- ``cold``: a build ran (a kernel library compiled or a graph captured);
- ``persistent-cache-hit``: no build, but a kernel library was found on
  disk and loaded;
- ``warm-reuse``: neither;

and, for any outcome but ``warm-reuse``, a cause: ``cache-eviction``
(this fingerprint and shapes were built before in this process, or the
fingerprint was evicted), a caller's hint (``first-eval``),
``shape-change`` / ``donation-change`` (the label seen before with other
shapes or donation), else ``new-fingerprint``. A build emits one
``program`` record onto the active recorder; a ``warm-reuse`` close emits
at most one per (fingerprint, label), so a warm repeat request emits no
build record at all. Every emitted record is also kept in a bounded
in-process ledger (:func:`events`).

A scope is dict arithmetic: no host sync, no device work, and a clock
read only for the ``ts`` of a record an enabled recorder takes. Stdlib
only, so it imports before torch.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional

from blades_tpu_torch.telemetry import recorder as _recorder

#: process-counter name -> field name in scopes and emitted records (the
#: module docstring's table)
_SCOPE_FIELDS = {
    "cuda.graph_capture_s": "trace_s",
    "cuda.kernel_build_s": "compile_s",
    "cuda.kernel_builds": "compiles",
    "cuda.graph_captures": "compiles",
    "cuda.kernel_reuses": "cache_hits",
}

_INT_FIELDS = frozenset({"compiles", "cache_hits"})

#: the seconds that must tile the process-wide mirror
SECONDS_FIELDS = ("trace_s", "compile_s")

CAUSES = (
    "new-fingerprint",
    "shape-change",
    "donation-change",
    "cache-eviction",
    "first-eval",
)
OUTCOMES = ("cold", "persistent-cache-hit", "warm-reuse")

#: bounded ledger of emitted records (the oldest dropped first)
_MAX_EVENTS = 4096

_lock = threading.RLock()
_tls = threading.local()

# -- registry state (all guarded by _lock but the thread-local stack) ----------
_attributed: Dict[str, float] = {}
_unattributed: Dict[str, float] = {}
_label_shapes: Dict[str, str] = {}
_label_donation: Dict[str, str] = {}
_built_keys: set = set()      # (fingerprint, shapes_key) built before
_evicted: set = set()         # fingerprints evicted from a warm cache
_warm_emitted: set = set()    # (fingerprint, label) warm record already out
_programs: Dict[str, Dict[str, Any]] = {}
_events: List[Dict[str, Any]] = []
_events_dropped = 0


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _key_str(value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, str):
        return value
    return repr(value)


def derive_fingerprint(label: str, shapes: Any = None, donation: Any = None) -> str:
    """The fingerprint of a call site with no ``EngineCache`` key: sha256
    over (label, shapes, donation), 12 hex digits."""
    basis = "|".join((str(label), _key_str(shapes), _key_str(donation)))
    return hashlib.sha256(basis.encode()).hexdigest()[:12]


def _observe(name: str, inc: float) -> None:
    """Counter observer: one process-counter increment to the innermost
    open scope on this thread, or to the unattributed bucket."""
    field = _SCOPE_FIELDS.get(name)
    if field is None:
        return
    st = getattr(_tls, "stack", None)
    if st:
        counts = st[-1].counts
        counts[field] = counts.get(field, 0) + inc
        bucket = _attributed
    else:
        bucket = _unattributed
    with _lock:
        bucket[field] = bucket.get(field, 0) + inc


class _Watch:
    """One open program scope."""

    __slots__ = ("label", "fingerprint", "shapes_key", "donation_key", "cause_hint", "counts")

    def __init__(self, label, fingerprint, shapes, donation, cause_hint):
        self.label = str(label)
        self.fingerprint = fingerprint
        self.shapes_key = _key_str(shapes)
        self.donation_key = _key_str(donation)
        self.cause_hint = cause_hint
        self.counts: Dict[str, float] = {}

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # a mis-nested close must not wedge the stack
            st.remove(self)
        try:
            _close(self)
        except Exception:  # noqa: BLE001 - provenance must never fail a run
            pass
        return False


def watch(label: str, *, fingerprint: Optional[str] = None, shapes: Any = None,
          donation: Any = None, cause_hint: Optional[str] = None) -> _Watch:
    """Bracket one program's dispatch: ``with programs.watch("engine/round",
    fingerprint=fp, shapes=(cx.shape, cy.shape)):``.

    ``fingerprint``: the program's identity (the ``EngineCache`` key where
    there is one, else derived from label, shapes and donation);
    ``shapes`` / ``donation``: any value with a stable ``repr`` (they feed
    the shape-change and donation-change causes); ``cause_hint``: a cause
    the call site knows (``"first-eval"``). Nested scopes attribute to the
    innermost."""
    return _Watch(label, fingerprint, shapes, donation, cause_hint)


def _classify_cause(scope: _Watch, fp: str) -> str:
    if (fp, scope.shapes_key) in _built_keys or fp in _evicted:
        return "cache-eviction"
    if scope.label not in _label_shapes:
        return scope.cause_hint or "new-fingerprint"
    if _label_shapes[scope.label] != scope.shapes_key:
        return "shape-change"
    if _label_donation.get(scope.label) != scope.donation_key:
        return "donation-change"
    return scope.cause_hint or "new-fingerprint"


def _close(scope: _Watch) -> None:
    global _events_dropped
    c = scope.counts
    if c.get("compiles"):
        outcome = "cold"
    elif any(c.get(f) for f in set(_SCOPE_FIELDS.values())):
        outcome = "persistent-cache-hit"
    else:
        outcome = "warm-reuse"
    fp = scope.fingerprint or derive_fingerprint(scope.label, scope.shapes_key,
                                                 scope.donation_key)
    with _lock:
        cause = None
        if outcome != "warm-reuse":
            cause = _classify_cause(scope, fp)
            _built_keys.add((fp, scope.shapes_key))
            _evicted.discard(fp)
        _label_shapes[scope.label] = scope.shapes_key
        _label_donation[scope.label] = scope.donation_key
        entry = _programs.setdefault(fp, {"program": scope.label, "builds": 0, "warm": 0,
                                          "trace_s": 0.0, "compile_s": 0.0, "compiles": 0})
        if outcome == "warm-reuse":
            entry["warm"] += 1
        else:
            entry["builds"] += 1
            entry["last_cause"] = cause
            for f in SECONDS_FIELDS:
                entry[f] = round(entry[f] + c.get(f, 0.0), 6)
            entry["compiles"] += int(c.get("compiles", 0))
        entry["last_outcome"] = outcome
        if outcome == "warm-reuse":
            wkey = (fp, scope.label)
            if wkey in _warm_emitted:
                return
            _warm_emitted.add(wkey)
        rec = _recorder.get_recorder()
        record: Dict[str, Any] = {"program": scope.label, "fingerprint": fp,
                                  "outcome": outcome}
        if rec.enabled:  # with telemetry off no clock is read
            record["ts"] = time.time()
        if cause is not None:
            record["cause"] = cause
        if scope.shapes_key:
            record["shapes"] = scope.shapes_key
        if scope.donation_key:
            record["donation"] = scope.donation_key
        for f in ("trace_s", "compile_s", "compiles", "cache_hits"):
            v = c.get(f)
            if v:
                record[f] = int(v) if f in _INT_FIELDS else round(v, 6)
        _events.append(record)
        if len(_events) > _MAX_EVENTS:
            excess = len(_events) - _MAX_EVENTS // 2
            del _events[:excess]
            _events_dropped += excess
    if rec.enabled:
        rec.event("program", **record)


def note_eviction(fingerprint: str) -> None:
    """Mark ``fingerprint`` evicted from a warm cache (``EngineCache``): its
    next build's cause is ``cache-eviction``, not a new program."""
    with _lock:
        _evicted.add(str(fingerprint))


def events() -> List[Dict[str, Any]]:
    """The bounded in-process ledger of emitted ``program`` records, in
    order, whichever recorder was active: take ``len(events())`` before a
    window and slice after."""
    with _lock:
        return [dict(e) for e in _events]


def snapshot() -> Dict[str, Any]:
    """Attributed and unattributed totals, the attributed share of build
    seconds (``coverage``), and the per-fingerprint aggregates."""
    with _lock:
        attr = dict(_attributed)
        unattr = dict(_unattributed)
        progs = {fp: dict(v) for fp, v in _programs.items()}
        emitted = len(_events)
        dropped = _events_dropped
    attr_s = sum(attr.get(f, 0.0) for f in SECONDS_FIELDS)
    total_s = attr_s + sum(unattr.get(f, 0.0) for f in SECONDS_FIELDS)
    return {
        "attributed": attr,
        "unattributed": unattr,
        "coverage": round(attr_s / total_s, 6) if total_s else 1.0,
        "programs": progs,
        "emitted": emitted,
        "dropped": dropped,
    }


def reset() -> None:
    """Drop the whole registry (tests; a fresh measurement window). Only
    the calling thread's scope stack is cleared."""
    global _events_dropped
    with _lock:
        _attributed.clear()
        _unattributed.clear()
        _label_shapes.clear()
        _label_donation.clear()
        _built_keys.clear()
        _evicted.clear()
        _warm_emitted.clear()
        _programs.clear()
        del _events[:]
        _events_dropped = 0
    _tls.stack = []


# armed at import: the observer is dict arithmetic on the rare build events
_recorder.add_counter_observer(_observe)
