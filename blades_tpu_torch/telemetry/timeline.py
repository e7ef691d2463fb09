"""Dispatch and sweep accounting: where the wall clock of a round or a
sweep cell goes.

Counterpart: ``blades_tpu/telemetry/timeline.py``, copied: launch
accounting (``launch_begin`` / ``launch_enqueued`` / ``launch_ready`` /
``emit`` / ``reset``, :126-240) and sweep accounting (``SweepAccounting`` with ``resume``,
``sweep_cell_event``, ``sweep_batch_events``, :256-489). Stdlib only.

**Launch accounting** splits each round (or block) the engine issues into

- ``enqueue_s``: host time from ``launch_begin`` (the engine's
  ``run_round_donated`` / ``run_block``) until the round's work is issued
  (``launch_enqueued``, when the engine returns: the card runs behind);
- ``ready_s``: from there until ``launch_ready``, which
  ``Simulator.run`` calls right after the wait its round (block) already
  does, the ``sync`` span's ``torch.cuda.synchronize``. No hook adds a
  host sync: each is a ``time.perf_counter`` read and dict arithmetic.

Launches fold into an accumulator per kind (``round`` / ``block``), and
:func:`emit` writes one ``timeline`` record per kind at the run's existing
flush (``Simulator._flush_rounds``), so the once-per-round flush stays.
``dispatch_share`` is ``enqueue_s / (enqueue_s + ready_s)``.

The JAX record's compile fields come from XLA's compile events. The port
compiles no XLA program; it fills them from the process counters of
``telemetry/recorder.py`` (:data:`~.recorder.PROCESS_COUNTER_NAMES`):
``compiles`` counts CUDA-graph captures plus kernel builds by ``nvcc``,
``compile_s`` their seconds, ``cache_misses`` the ``nvcc`` builds and
``cache_hits`` the kernel libraries found up to date on disk. There is no
``trace_s``.

**Sweep accounting** (:class:`SweepAccounting`): one ``sweep`` record per
cell of a long sweep (``examples/certify.py``), flushed at the cell
boundary into the sweep's own file-backed recorder, with a heartbeat beat
(``supervision/heartbeat.py``); :func:`sweep_cell_event` and
:func:`sweep_batch_events` write the library-level records of
``audit/attack_search.py`` onto the active recorder.

With telemetry off (``BLADES_TELEMETRY=0``) every hook is an attribute
check and an early return: no clock read, no record.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from blades_tpu_torch.telemetry import recorder as _recorder

#: record field -> the process counters it sums
_COUNTER_FIELDS = (
    ("compiles", ("cuda.graph_captures", "cuda.kernel_builds")),
    ("compile_s", ("cuda.graph_capture_s", "cuda.kernel_build_s")),
    ("cache_hits", ("cuda.kernel_reuses",)),
    ("cache_misses", ("cuda.kernel_builds",)),
)

#: count-like record fields emitted as ints (the rest are seconds)
_INT_FIELDS = frozenset({"compiles", "cache_hits", "cache_misses"})


def counter_delta(before: Dict[str, float]) -> Dict[str, float]:
    """The build-counter deltas since the snapshot ``before``, under the
    record's field names (zero deltas left out)."""
    now = _recorder.process_counters()
    out: Dict[str, float] = {}
    for short, keys in _COUNTER_FIELDS:
        d = sum(now.get(key, 0) - before.get(key, 0) for key in keys)
        if d:
            out[short] = int(d) if short in _INT_FIELDS else d
    return out


# -- launch accounting ---------------------------------------------------------


class _Launch:
    """One round (or block) in flight: at most one at a time."""

    __slots__ = ("kind", "rounds", "attrs", "t0", "t_enqueued", "counters0")

    def __init__(self, kind: str, rounds: int, attrs: Optional[dict]):
        self.kind = kind
        self.rounds = int(rounds)
        self.attrs = dict(attrs or {})
        self.t0 = time.perf_counter()
        self.t_enqueued: Optional[float] = None
        self.counters0 = _recorder.process_counters()


_open_launch: Optional[_Launch] = None

#: kind -> accumulated splits since the last :func:`emit`
_acc: Dict[str, Dict[str, Any]] = {}


def launch_begin(kind: str, rounds: int = 1, attrs: Optional[dict] = None) -> None:
    """Open a launch window as the engine starts a round (``kind="round"``)
    or a block (``"block"``, ``rounds`` of them); ``attrs`` are static
    labels copied onto the record (``streaming``, ``async``). No-op when
    the active recorder is off. A launch still open (its caller never
    waited) folds with ``ready_s = 0``."""
    global _open_launch
    if not _recorder.get_recorder().enabled:
        return
    if _open_launch is not None:
        _fold(_open_launch, 0.0)
    _open_launch = _Launch(kind, rounds, attrs)


def launch_enqueued() -> None:
    """Mark the end of the host's issue of the round's work."""
    launch = _open_launch
    if launch is not None:
        launch.t_enqueued = time.perf_counter()


def launch_ready(ready_s: Optional[float] = None) -> None:
    """Close the open launch after the caller's existing wait on the card;
    ``ready_s`` defaults to now minus :func:`launch_enqueued`."""
    global _open_launch
    launch = _open_launch
    if launch is None:
        return
    _open_launch = None
    _fold(launch, ready_s)


def _fold(launch: _Launch, ready_s: Optional[float]) -> None:
    now = time.perf_counter()
    enq_end = launch.t_enqueued if launch.t_enqueued is not None else now
    enqueue_s = max(0.0, enq_end - launch.t0)
    if ready_s is None:
        ready_s = max(0.0, now - enq_end)
    acc = _acc.setdefault(launch.kind, {"launches": 0, "rounds": 0, "enqueue_s": 0.0,
                                        "ready_s": 0.0, "attrs": {}})
    acc["launches"] += 1
    acc["rounds"] += launch.rounds
    acc["enqueue_s"] += enqueue_s
    acc["ready_s"] += ready_s
    acc["attrs"].update(launch.attrs)
    for short, d in counter_delta(launch.counters0).items():
        acc[short] = acc.get(short, 0) + d


def emit(rec=None, round_idx: Optional[int] = None) -> None:
    """One ``timeline`` record per launch kind folded since the previous
    emit, onto ``rec`` (default: the active recorder), at the caller's
    existing flush; clears the accumulator either way."""
    global _acc
    acc, _acc = _acc, {}
    rec = rec if rec is not None else _recorder.get_recorder()
    if not rec.enabled:
        return
    for kind, a in acc.items():
        total = a["enqueue_s"] + a["ready_s"]
        fields: Dict[str, Any] = {
            "kind": kind,
            "launches": a["launches"],
            "rounds": a["rounds"],
            "enqueue_s": round(a["enqueue_s"], 6),
            "ready_s": round(a["ready_s"], 6),
            "dispatch_share": round(a["enqueue_s"] / total, 6) if total else 0.0,
        }
        if round_idx is not None:
            fields["round"] = int(round_idx)
        for short, _ in _COUNTER_FIELDS:
            if short in a:
                fields[short] = a[short] if short in _INT_FIELDS else round(a[short], 6)
        fields.update(a["attrs"])
        rec.event("timeline", **fields)


def reset() -> None:
    """Drop any accumulated, unemitted launch state (a run's start)."""
    global _open_launch, _acc
    _open_launch = None
    _acc = {}


# -- sweep accounting ----------------------------------------------------------


class SweepAccounting:
    """Per-cell accounting for a long sweep: its own file-backed recorder
    (``path``), one ``sweep`` record per completed cell with progress
    ``i``-of-``total`` and an ETA, flushed at the cell boundary, and a
    heartbeat beat there.

    Usage::

        sw = SweepAccounting("certify", total=n_cells, path=trace_path)
        with sw.cell("median/f1"):
            ...   # one cell's work
        sw.close()
    """

    def __init__(self, kind: str, total: int, path: Optional[str] = None,
                 meta: Optional[dict] = None):
        self.kind = kind
        self.total = int(total)
        self.done = 0
        self._t0 = time.perf_counter()
        self.rec = _recorder.Recorder(
            path=path,
            meta={"run": "sweep", "sweep": kind, "cells_total": int(total), **(meta or {})},
        )
        # the trace file exists from the start: a sweep killed in cell 0
        # still leaves one
        self.rec.flush()

    def resume(self, skipped: int, journal: Optional[str] = None, quarantined: int = 0) -> None:
        """Mark this attempt a journaled resume (``sweeps/journal.py``): one
        ``resume`` record, how many cells were recovered instead of run.
        The executor then writes a zero-wall ``resumed: true`` sweep record
        for each recovered cell, so the i-of-N trail stays monotone."""
        fields: Dict[str, Any] = {"sweep": self.kind, "skipped": int(skipped),
                                  "total": self.total, "ts": time.time()}
        if quarantined:
            fields["quarantined"] = int(quarantined)
        if journal:
            fields["journal"] = journal
        self.rec.event("resume", **fields)
        self.rec.flush()

    def cell(self, key: str, **fields):
        """Context manager accounting one cell (``fields``: extra labels the
        schema allows)."""
        return _Cell(self, str(key), fields)

    def record(self, key: str, wall_s: float, counter_delta: Optional[Dict[str, Any]] = None,
               **fields) -> None:
        """Mark one cell complete without the context manager (a group of
        cells that completed together; ``error=`` marks it failed)."""
        error = fields.pop("error", None)
        self._emit(str(key), float(wall_s), dict(counter_delta or {}), fields, error=error)

    def _emit(self, key: str, wall: float, delta: Dict[str, Any], fields: dict,
              error: Optional[str] = None, error_type: Optional[str] = None) -> None:
        self.done += 1
        rate = (time.perf_counter() - self._t0) / max(self.done, 1)
        rec_fields: Dict[str, Any] = {
            "sweep": self.kind,
            "cell": key,
            "ts": time.time(),
            "i": self.done,
            "total": self.total,
            "wall_s": round(wall, 6),
            "eta_s": round(max(0.0, rate * (self.total - self.done)), 1),
            "execute_s": round(max(0.0, wall - delta.get("compile_s", 0.0)), 6),
            **delta,
            **fields,
        }
        if error is not None:
            rec_fields["ok"] = False
            rec_fields["error"] = error[:300]
            if error_type is not None:
                rec_fields.setdefault("error_type", error_type)
        self.rec.event("sweep", **rec_fields)
        # the cell boundary: one buffered trace write and one heartbeat
        self.rec.flush()
        from blades_tpu_torch.supervision import heartbeat as _heartbeat

        _heartbeat.beat(round_idx=self.done)

    def summary(self) -> Dict[str, Any]:
        return {"sweep": self.kind, "cells": self.done, "total": self.total,
                "wall_s": round(time.perf_counter() - self._t0, 3)}

    def close(self) -> None:
        self.rec.close()


class _Cell:
    __slots__ = ("_sw", "_key", "_fields", "_t0", "_counters0")

    def __init__(self, sw: SweepAccounting, key: str, fields: dict):
        self._sw = sw
        self._key = key
        self._fields = fields

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._counters0 = _recorder.process_counters()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._sw._emit(
            self._key, time.perf_counter() - self._t0, counter_delta(self._counters0),
            self._fields,
            error=f"{exc_type.__name__}: {exc}" if exc_type is not None else None,
            error_type=exc_type.__name__ if exc_type is not None else None,
        )
        return False


def sweep_cell_event(sweep: str, cell: str, wall_s: float, counters_before: Dict[str, float],
                     rec=None, **fields) -> None:
    """One ``sweep`` record for an externally timed cell onto the active
    recorder (no flush: its owner keeps the cadence); a no-op when it is
    off."""
    rec = rec if rec is not None else _recorder.get_recorder()
    if not rec.enabled:
        return
    delta = counter_delta(counters_before)
    rec.event("sweep", sweep=sweep, cell=cell, ts=time.time(), wall_s=round(wall_s, 6),
              execute_s=round(max(0.0, wall_s - delta.get("compile_s", 0.0)), 6),
              **delta, **fields)


def sweep_batch_events(sweep: str, cells, wall_s: float, counters_before: Dict[str, float],
                       batch: str, rec=None, **fields) -> None:
    """One ``sweep`` record per cell of a group run together
    (``audit.attack_search.search_cells``): the shared ``batch`` key and
    ``batch_size``, the group's wall split evenly, and the group's counter
    delta on the first cell only (sums, not means). A no-op when the active
    recorder is off."""
    rec = rec if rec is not None else _recorder.get_recorder()
    if not rec.enabled:
        return
    cells = list(cells)
    if not cells:
        return
    delta = counter_delta(counters_before)
    share = wall_s / len(cells)
    exec_total = max(0.0, wall_s - delta.get("compile_s", 0.0))
    now = time.time()
    for i, cell in enumerate(cells):
        rec.event("sweep", sweep=sweep, cell=str(cell), ts=now, wall_s=round(share, 6),
                  execute_s=round(exec_total / len(cells), 6), batch=batch,
                  batch_size=len(cells), **(delta if i == 0 else {}), **fields)
