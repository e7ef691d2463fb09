"""Zero-dependency telemetry recorder: spans, counters, gauges -> JSONL.

Counterpart: ``blades_tpu/telemetry/recorder.py:95-345`` (``Recorder``
with its per-record ``observer`` :117-121 and :199, ``NULL_RECORDER``,
``get_recorder`` / ``set_recorder``, the process-wide counter mirror
``process_counters`` and ``add_counter_observer`` :321-345), copied: the
port imports nothing of the JAX package. The JAX module's
``install_jax_monitoring`` (:363), which feeds that mirror from XLA's
compile events, has no source here: the port compiles no XLA programs.
Its mirror is fed by :func:`count_process` instead, from the port's own
builds: a CUDA-graph capture (``core/graphs.py``) and a kernel library
built by ``nvcc`` or found up to date on disk (``ops/_build.py``); see
:data:`PROCESS_COUNTER_NAMES`. The build-provenance registry
(``telemetry/programs.py``) observes the same feed and attributes each
increment to the program scope open when it fired.

Design constraints (the recorder lives inside the round loop):

- **Disabled is free.** ``BLADES_TELEMETRY=0`` (or ``enabled=False``) makes
  every method an early-return no-op: no clock reads and no syscalls.
- **Buffered I/O.** Records accumulate in memory; :meth:`flush` writes the
  pending batch as one buffered write. Callers flush once per round (or
  block), never per span.
- **Stdlib only**, so it imports before torch.

JSONL record types (the schema is ``telemetry_schema.json`` beside this
module, a copy of ``docs/telemetry_schema.json``):

- ``{"t": "meta", ...}`` — one header record per trace file;
- ``{"t": "span", "path": "round/dispatch", "dur_s": ...}`` — a closed
  wall-clock span; ``path`` is the ``/``-joined open-span stack;
- ``{"t": "round", "round": N, "counters": {...}, "gauges": {...}}`` — a
  per-round summary carrying counter *deltas* since the previous round
  record (cumulative totals stay in :attr:`counters`);
- ``defense`` / ``faults`` / ``audit`` / ``metrics`` / ``async`` — the
  round's forensics (``simulator.Simulator._log_*``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional

from blades_tpu_torch.telemetry import context as _context


def telemetry_enabled() -> bool:
    """Environment default: on unless ``BLADES_TELEMETRY=0``."""
    return os.environ.get("BLADES_TELEMETRY", "1") != "0"


class _NullSpan:
    """Shared no-op context manager (the disabled span: no clock read)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span; closing emits one ``span`` record to its recorder."""

    __slots__ = ("_rec", "_name", "_attrs", "_start")

    def __init__(self, rec: "Recorder", name: str, attrs: dict):
        self._rec = rec
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._rec._stack.append(self._name)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._start
        stack = self._rec._stack
        path = "/".join(stack)
        if stack and stack[-1] == self._name:
            stack.pop()
        rec: Dict[str, Any] = {"t": "span", "path": path, "dur_s": dur}
        if self._attrs:
            rec.update(self._attrs)
        self._rec._emit(rec)
        return False


class Recorder:
    """Nested wall-clock spans, monotonic counters, gauges; a JSONL sink.

    ``path=None`` keeps records in memory only (bounded by ``max_buffer``,
    oldest dropped first). With a ``path``, :meth:`flush` appends pending
    records to the file in one buffered write.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        enabled: Optional[bool] = None,
        meta: Optional[dict] = None,
        max_buffer: int = 65536,
    ):
        self.enabled = telemetry_enabled() if enabled is None else bool(enabled)
        self.path = path if self.enabled else None
        self.max_buffer = int(max_buffer)
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.dropped = 0
        #: optional per-record observer (the alert engine,
        #: ``telemetry/alerts.py``): called from :meth:`_emit` with each
        #: record as it enters the buffer; pure Python, no I/O
        self.observer: Optional[Callable[[Dict[str, Any]], None]] = None
        self._stack: list = []
        self._pending: list = []  # records not yet flushed to the sink
        self._fh = None
        self._last_counts: Dict[str, float] = {}
        # the run identity stamped onto every record (telemetry/context.py);
        # disabled recorders never touch it
        self._envelope: Dict[str, Any] = {}
        if self.enabled:
            ctx = _context.activate()
            self._envelope = {"run_id": ctx.run_id, "attempt": ctx.attempt}
            rec: Dict[str, Any] = {"t": "meta", "ts": time.time(), "pid": os.getpid()}
            if meta:
                rec.update(meta)
            self._emit(rec)

    # -- recording ------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing a nested stage. Path = the open-span stack
        joined with ``/`` (e.g. ``round/dispatch``)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, attrs)

    def counter(self, name: str, inc: float = 1) -> None:
        """Add ``inc`` to a cumulative counter (ints or seconds)."""
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value) -> None:
        """Set a point-in-time value (last write wins)."""
        if not self.enabled:
            return
        self.gauges[name] = value

    def event(self, type_: str, **fields) -> None:
        """Emit a free-form record (``t`` = ``type_``)."""
        if not self.enabled:
            return
        self._emit({"t": type_, **fields})

    def round_record(self, round_idx: int, **fields) -> None:
        """Per-round summary: caller fields + counter deltas since the last
        round record + current gauges. The natural flush point."""
        if not self.enabled:
            return
        delta = {
            k: v - self._last_counts.get(k, 0)
            for k, v in self.counters.items()
            if v != self._last_counts.get(k, 0)
        }
        self._last_counts = dict(self.counters)
        self._emit({"t": "round", "round": round_idx, **fields, "counters": delta,
                    "gauges": dict(self.gauges)})

    def snapshot(self) -> Dict[str, Any]:
        """Current cumulative counters + gauges."""
        return {"counters": dict(self.counters), "gauges": dict(self.gauges)}

    # -- sink -----------------------------------------------------------------

    def _emit(self, record: Dict[str, Any]) -> None:
        for k, v in self._envelope.items():
            # a record carrying its own field of the same name wins
            record.setdefault(k, v)
        self._pending.append(record)
        obs = self.observer
        if obs is not None:
            try:
                # the alert engine may emit `alert` records back into this
                # recorder (not a type it watches, so no recursion); a
                # broken rule must never take down the run
                obs(record)
            except Exception:  # noqa: BLE001 - observability must not raise
                pass
        if len(self._pending) > self.max_buffer:
            # bound the buffer, never the run: the oldest unflushed records
            # drop first, counted in `dropped`
            excess = len(self._pending) - self.max_buffer // 2
            del self._pending[:excess]
            self.dropped += excess

    def flush(self) -> None:
        """Write all pending records to the sink in one buffered write.
        Memory-only recorders keep their records (see :attr:`records`).

        Sink failures (directory gone, disk full, a record that does not
        serialize) never propagate: telemetry must not take down the run it
        observes. The batch is counted into :attr:`dropped` and the handle
        reset, so a later flush retries."""
        if not self.enabled or self.path is None or not self._pending:
            return
        batch = self._pending
        self._pending = []
        try:
            if self._fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "a", buffering=1024 * 1024)
            self._fh.write("".join(json.dumps(r, default=_json_default) + "\n" for r in batch))
            self._fh.flush()
        except (OSError, TypeError, ValueError):
            self.dropped += len(batch)
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    @property
    def records(self) -> list:
        """Unflushed records (the whole trace for memory-only recorders)."""
        return list(self._pending)

    def close(self) -> None:
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _json_default(obj):
    """Serialize numpy and torch scalars and small arrays without importing
    either."""
    for attr in ("item", "tolist"):
        if hasattr(obj, attr):
            try:
                return getattr(obj, attr)()
            except Exception:  # noqa: BLE001 - fall through to repr
                pass
    return repr(obj)


#: Disabled singleton — the default target until someone installs a real one.
NULL_RECORDER = Recorder(enabled=False)

_global_recorder: Recorder = NULL_RECORDER


def get_recorder() -> Recorder:
    """The process-wide active recorder (NULL_RECORDER until one is set:
    instrumentation sites call methods unconditionally)."""
    return _global_recorder


def set_recorder(rec: Optional[Recorder]) -> Recorder:
    """Install ``rec`` as the active recorder (``None`` -> NULL_RECORDER);
    returns the previous one, flushed and with its file handle closed (it
    stays usable: :meth:`Recorder.flush` reopens the sink on demand)."""
    global _global_recorder
    prev = _global_recorder
    if prev is not NULL_RECORDER:
        prev.close()
    _global_recorder = rec if rec is not None else NULL_RECORDER
    return prev


# -- process-wide build counters ------------------------------------------------

#: the counters :func:`count_process` feeds, and what each counts:
#:
#: - ``cuda.graph_captures`` / ``cuda.graph_capture_s``: CUDA graphs of a
#:   round captured (``core/graphs.py:RoundGraph._capture``), and their
#:   wall seconds;
#: - ``cuda.kernel_builds`` / ``cuda.kernel_build_s``: kernel libraries
#:   compiled by ``nvcc`` (``ops/_build.py:build``), and their seconds;
#: - ``cuda.kernel_reuses``: kernel libraries found up to date on disk
#:   instead (the build cache's hits).
PROCESS_COUNTER_NAMES = (
    "cuda.graph_captures", "cuda.graph_capture_s", "cuda.kernel_builds",
    "cuda.kernel_build_s", "cuda.kernel_reuses",
)

#: process-wide cumulative mirror of the build counters, fed whichever
#: recorder is active (or none): the timeline's launch and sweep accounting
#: takes deltas of it, which a recorder swap cannot tear
_PROCESS_COUNTERS: Dict[str, float] = {}

_counter_observers: list = []


def process_counters() -> Dict[str, float]:
    """Snapshot of the process-wide build counters (cumulative)."""
    return dict(_PROCESS_COUNTERS)


def add_counter_observer(fn: Callable[[str, float], None]) -> None:
    """Register ``fn(counter_name, inc)`` on the process-counter feed
    (once per function object)."""
    if fn not in _counter_observers:
        _counter_observers.append(fn)


def count_process(name: str, inc: float = 1) -> None:
    """Add ``inc`` to the process counter ``name``, tell the observers, and
    count it on the active recorder too (so it rides the next ``round``
    record's counter deltas; a no-op there when telemetry is off). Dict
    operations only: no clock read, no I/O, no device work."""
    _PROCESS_COUNTERS[name] = _PROCESS_COUNTERS.get(name, 0) + inc
    for fn in _counter_observers:
        try:
            fn(name, inc)
        except Exception:  # noqa: BLE001 - observability must not raise
            pass
    get_recorder().counter(name, inc)
