"""Resilient sweep execution: retry, deadlines, quarantine by bisection and
journaled resume.

Counterpart: ``blades_tpu/sweeps/resilient.py`` — ``DeadlineExceeded`` and
``soft_deadline`` (:119), ``ResilienceOptions`` (:143),
``ResilienceReport`` (:212, with ``preempted`` :223-225),
``_emit_retry`` (:270), ``_quarantine_cell``
(:292), ``_recover_cell`` (:336), ``run_cells_resilient`` (:373) and
``run_grouped_resilient`` (:495, with ``_attempt`` :537, ``_commit`` :575
and the bisection ``_solve`` :603). The same records (``retry``,
``quarantine``, ``resume``, ``deadline_unenforced`` and the driver's
``sweep`` records) in the same order, the same report and the same result
slots, on the same failures.

The ladder: a failed execution is retried on the backoff curve of
``utils/retry.py`` (a ``retry`` record each); a batched group that fails
its whole budget is split in halves, recursively, each half re-entering
:func:`~blades_tpu_torch.sweeps._execute_group` (one attempt a half, the
full budget again for a single cell), so the largest passing subgroups
keep their results; a cell that still fails is quarantined with its
error's type and message (a ``quarantine`` record, a journal entry, and
``None`` in its result slot) and the sweep goes on. With a
:class:`~.journal.SweepJournal` each finished cell is journaled at its
boundary, journal first and trace second, and a resumed sweep recovers
the journaled cells (a zero-wall ``resumed: true`` sweep record each) and
runs only the rest. Results are bit for bit what ``run_grouped`` gives,
since every path re-enters the same body.

Two rules are the port's own, for a CUDA card:

- **A dead device is not a poison cell.** After an illegal address or a
  device-side assert every later CUDA call fails, so every retry, every
  bisection half and every single cell would fail too, and each would be
  quarantined and journaled; a resume never runs a quarantined cell again.
  So after every failed attempt the executor probes the device
  (:func:`probe_device`, a synchronize); if the probe fails too it raises
  :class:`DeviceLost` at once and journals nothing. The process dies, and
  its supervisor relaunches it under ``BLADES_RESUME=1``. A process that
  never imported torch has no CUDA context to lose and is not probed: a
  failing cell of a probe-only service must not load torch into it.
- **A failed attempt holds no memory into the next.** The failure is
  kept as its type and message only (:class:`_Failure`); the exception's
  frames, and the device tensors in them, are cleared before the backoff
  sleep, so a retry after ``torch.cuda.OutOfMemoryError`` finds the memory
  of the attempt that failed free.

:func:`soft_deadline` bounds an execution of C cells by C times
``cell_deadline_s`` with SIGALRM. It fires between bytecodes only: a
``torch.cuda.synchronize()`` or a long kernel delays it to its return, and
it works from the main thread only; anywhere else a
``deadline_unenforced`` record says so, once an execution. The
supervisor's heartbeat watchdog (``supervision/supervisor.py``) is the
hard limit.
"""

from __future__ import annotations

import dataclasses
import signal
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence

from blades_tpu_torch.sweeps import SweepCell, _execute_group, plan_groups
from blades_tpu_torch.sweeps.journal import SweepJournal
from blades_tpu_torch.telemetry import recorder as _trecorder
from blades_tpu_torch.telemetry.timeline import counter_delta
from blades_tpu_torch.utils.retry import backoff_delay

__all__ = [
    "DeadlineExceeded",
    "DeviceLost",
    "ResilienceOptions",
    "ResilienceReport",
    "probe_device",
    "run_cells_resilient",
    "run_grouped_resilient",
    "soft_deadline",
]


class DeadlineExceeded(Exception):
    """A sweep cell's or group's execution overran its soft deadline."""


class DeviceLost(RuntimeError):
    """An attempt failed and the device then failed its probe: the CUDA
    context is dead, and no cell is to blame."""


def probe_device() -> None:
    """Raise when the CUDA context of this process is dead: a synchronize,
    where the process has initialized CUDA (a no-op otherwise, and in a
    process that never imported torch)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class _Failure:
    """What the records keep of a failed attempt: the error's type and
    ``"Type: message"``, never the exception."""

    error_type: str
    error: str


def _clear_frames(exc: Optional[BaseException]) -> None:
    """Drop the frames of ``exc`` (and of its cause and context): their
    locals, device tensors among them, are freed when the last reference
    goes."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
            exc.__traceback__ = None
        exc = exc.__cause__ or exc.__context__


def _failed(exc: Exception) -> _Failure:
    """The record of a failed attempt; raises :class:`DeviceLost` when the
    device then fails its probe."""
    failure = _Failure(type(exc).__name__, f"{type(exc).__name__}: {exc}"[:300])
    try:
        probe_device()
    except Exception as probe_err:  # noqa: BLE001 - any failure of the probe
        raise DeviceLost(
            f"{failure.error}; then the device failed its probe "
            f"({type(probe_err).__name__}: {probe_err})"[:500]
            + ": nothing quarantined; relaunch under BLADES_RESUME=1") from exc
    _clear_frames(exc)
    return failure


def _alarm_usable() -> bool:
    return hasattr(signal, "setitimer") and threading.current_thread() is threading.main_thread()


@contextmanager
def soft_deadline(seconds: Optional[float]):
    """Raise :class:`DeadlineExceeded` in the calling (main) thread after
    ``seconds``, at the next bytecode. ``None``/``0``, or a caller off the
    main thread, arms nothing (yields ``False``)."""
    if not seconds or seconds <= 0 or not _alarm_usable():
        yield False
        return

    def _trip(signum, frame):
        raise DeadlineExceeded(f"exceeded soft deadline of {seconds:.1f}s")

    prev = signal.signal(signal.SIGALRM, _trip)
    signal.setitimer(signal.ITIMER_REAL, float(seconds))
    try:
        yield True
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, prev)


@dataclasses.dataclass
class ResilienceOptions:
    """The resilient executors' settings.

    ``attempts`` is the retry budget of an execution unit: a whole batched
    group, and again an isolated single cell before its quarantine (a
    bisection half gets one attempt). ``cell_deadline_s`` scales with the
    unit: C cells get C times it. ``sleep`` and ``runner`` (``runner(group,
    key)`` in place of :func:`~blades_tpu_torch.sweeps._execute_group`)
    are for tests and for the card's fault injection.

    ``should_yield``: polled at cell (per-cell executor) or group (batched
    executor) boundaries after at least one unit of new work; ``True``
    stops the sweep with ``report.preempted`` set and every remaining slot
    ``None``, not quarantined: the caller requeues, and a later execution
    recovers the journaled cells and runs the rest (the service's
    cell-boundary preemption, ``service/scheduler.py``). The one unit of
    progress makes back-to-back preemptions advance the journal. The JAX
    package's worker-pool hooks (``deadline="external"``,
    ``on_cell_start``) come with the pool (``ROADMAP.md`` queue A, slice
    13b.2)."""

    attempts: int = 2
    base_delay_s: float = 0.5
    max_delay_s: float = 30.0
    cell_deadline_s: Optional[float] = None
    sleep: Callable[[float], None] = time.sleep
    runner: Optional[Callable[[Sequence[SweepCell], str], list]] = None
    should_yield: Optional[Callable[[], bool]] = None

    def __post_init__(self):
        # a budget below 1 would skip every attempt and quarantine every
        # cell with an error nothing raised
        self.attempts = max(1, int(self.attempts))


@dataclasses.dataclass
class ResilienceReport:
    """What the executor did beyond plain execution: a sweep that retried
    or resumed is not the evidence a clean one is."""

    retried: int = 0
    degraded_groups: int = 0
    executed: int = 0
    resumed_skipped: int = 0
    #: the sweep stopped at a boundary because ``options.should_yield``
    #: asked it to; the remaining slots are None and not quarantined
    preempted: bool = False
    quarantined: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        return {
            "executed": self.executed,
            "resumed_skipped": self.resumed_skipped,
            "retried": self.retried,
            "degraded_groups": self.degraded_groups,
            "quarantined": [q["cell"] for q in self.quarantined],
        }


# -- the record-writing steps both executors share ------------------------------


def _note_deadline_unenforced(rec, kind: str, *, deadline_s: float) -> None:
    """A per-cell deadline SIGALRM cannot enforce here (off the main thread,
    or no ``setitimer``): the trace says so instead of the deadline
    vanishing."""
    reason = "no_setitimer" if not hasattr(signal, "setitimer") else "non_main_thread"
    rec.event("deadline_unenforced", sweep=kind, reason=reason, deadline_s=float(deadline_s),
              ts=time.time())
    rec.flush()


def _emit_retry(rec, report: ResilienceReport, kind: str, *, what: str, attempt: int,
                delay: float, failure: _Failure, batch: Optional[str] = None,
                cell: Optional[str] = None) -> None:
    report.retried += 1
    fields: Dict[str, Any] = {"sweep": kind}
    if batch is not None:
        fields["batch"] = batch
    if cell is not None:
        fields["cell"] = cell
    rec.event("retry", what=what, attempt=attempt, delay_s=delay, error=failure.error, **fields)
    rec.flush()


def _quarantine_cell(rec, sweep, journal: Optional[SweepJournal], report: ResilienceReport,
                     kind: str, label: str, failure: _Failure, *, attempts: int,
                     batch: Optional[str] = None, wall: float = 0.0,
                     delta: Optional[Dict[str, Any]] = None) -> None:
    """Quarantine one cell: its journal entry (a resume must not run it
    again), a ``quarantine`` record and a failed driver record with the
    last attempt's wall and counters."""
    info = {"cell": label, "error": failure.error, "error_type": failure.error_type,
            "batch": batch, "attempts": attempts}
    report.quarantined.append(info)
    if journal is not None:
        journal.record_quarantine(label, failure.error, failure.error_type, batch=batch,
                                  attempts=attempts)
    event: Dict[str, Any] = {"sweep": kind, "cell": label, "ts": time.time(),
                             "error": failure.error, "error_type": failure.error_type,
                             "attempts": attempts}
    if batch is not None:
        event["batch"] = batch
    rec.event("quarantine", **event)
    if sweep is not None:
        extra = {"batch": batch} if batch is not None else {}
        sweep.record(label, wall, counter_delta=delta, error=failure.error,
                     error_type=failure.error_type, quarantined=True, **extra)
    else:
        rec.flush()


def _recover_cell(journal: SweepJournal, sweep, report: ResilienceReport, label: str, *,
                  batch: Optional[str] = None):
    """Recover one journaled cell on a resume: ``(result, wall)``, or
    ``(None, 0.0)`` for a journaled quarantine, and a zero-wall
    ``resumed: true`` driver record (the interrupted attempt recorded the
    real wall)."""
    report.resumed_skipped += 1
    extra = {"batch": batch} if batch is not None else {}
    entry = journal.entry(label)
    if entry is not None:
        if sweep is not None:
            sweep.record(label, 0.0, resumed=True, **extra)
        return entry["result"], float(entry.get("wall_s", 0.0))
    q = journal.quarantined()[label]
    report.quarantined.append({"cell": label, "error": q.get("error", ""),
                               "error_type": q.get("error_type", "Exception"),
                               "batch": q.get("batch", batch), "attempts": q.get("attempts")})
    if sweep is not None:
        sweep.record(label, 0.0, resumed=True, quarantined=True, error=q.get("error", ""),
                     error_type=q.get("error_type", "Exception"), **extra)
    return None, 0.0


# -- the per-cell executor ----------------------------------------------------


def run_cells_resilient(cells, run_cell: Callable[[Any], Any], *, sweep=None,
                        journal: Optional[SweepJournal] = None,
                        options: Optional[ResilienceOptions] = None,
                        kind: Optional[str] = None):
    """The resilient loop for sweeps whose cells are their own execution
    unit (``examples/chaos.py``'s seeds, ``examples/certify.py
    --sequential``): journal recovery, retry, soft deadline, quarantine,
    no bisection.

    ``cells``: ``(label, payload)`` pairs; ``run_cell(payload)`` runs one
    and returns its JSON-serializable result. Returns ``(results, walls,
    report)``, a quarantined (or, preempted, an unrun) cell's slot
    ``None``."""
    options = options or ResilienceOptions()
    cells = list(cells)
    kind = kind or getattr(sweep, "kind", "sweep")
    rec = getattr(sweep, "rec", None) or _trecorder.get_recorder()
    results: List[Any] = []
    walls: List[float] = []
    report = ResilienceReport()

    cell_ddl = options.cell_deadline_s
    if cell_ddl and not _alarm_usable():
        _note_deadline_unenforced(rec, kind, deadline_s=cell_ddl)

    progressed = 0
    for label, payload in cells:
        if journal is not None and journal.has(label):
            result, wall = _recover_cell(journal, sweep, report, label)
            results.append(result)
            walls.append(wall)
            continue

        # cell-boundary preemption, after one cell of new work (a recovered
        # cell is none); the remaining slots pad to None
        if report.preempted or (progressed and options.should_yield is not None
                                and options.should_yield()):
            report.preempted = True
            results.append(None)
            walls.append(0.0)
            continue

        out = None
        failure: Optional[_Failure] = None
        wall = 0.0
        delta: Dict[str, Any] = {}
        for attempt in range(1, options.attempts + 1):
            t0 = time.perf_counter()
            counters0 = _trecorder.process_counters()
            try:
                with soft_deadline(cell_ddl):
                    out = run_cell(payload)
            except Exception as e:  # noqa: BLE001 - retried, then quarantined
                failure = _failed(e)
            else:
                failure = None
            wall = time.perf_counter() - t0
            delta = counter_delta(counters0)
            if failure is None or attempt == options.attempts:
                break
            delay = backoff_delay(attempt, options.base_delay_s, options.max_delay_s)
            _emit_retry(rec, report, kind, what="sweep_cell", attempt=attempt, delay=delay,
                        failure=failure, cell=label)
            options.sleep(delay)

        if failure is not None:
            _quarantine_cell(rec, sweep, journal, report, kind, label, failure,
                             attempts=options.attempts, wall=wall, delta=delta)
            results.append(None)
            walls.append(wall)
            progressed += 1
            continue
        if journal is not None:
            journal.record(label, out, wall_s=wall)
        if sweep is not None:
            extra = {"retries": attempt - 1} if attempt > 1 else {}
            sweep.record(label, wall, counter_delta=delta, **extra)
        results.append(out)
        walls.append(wall)
        report.executed += 1
        progressed += 1

    return results, walls, report


# -- the batched (program-shape grouped) executor -----------------------------


def run_grouped_resilient(cells: Sequence[SweepCell], *, grids: Optional[dict] = None,
                          sweep=None, journal: Optional[SweepJournal] = None,
                          options: Optional[ResilienceOptions] = None):
    """Attack-search cells grouped by program shape, run resiliently: the
    plain ``run_grouped(..., return_walls=True)`` with a third value,
    ``(results, walls, report)``. Results in input order, a quarantined
    cell's slot ``None``; a clean run with an empty journal runs the plain
    executor's calls and gives its results.

    ``sweep``: the driver's ``telemetry.timeline.SweepAccounting`` or
    None; ``journal``: a :class:`~.journal.SweepJournal` (cells it holds
    are recovered, each finished cell journaled); ``options``:
    :class:`ResilienceOptions`."""
    options = options or ResilienceOptions()
    cells = list(cells)
    results: List[Optional[Dict[str, Any]]] = [None] * len(cells)
    walls: List[float] = [0.0] * len(cells)
    report = ResilienceReport()
    kind = getattr(sweep, "kind", "sweep")
    rec = getattr(sweep, "rec", None) or _trecorder.get_recorder()
    runner = options.runner or (lambda group, key: _execute_group(group, key, grids=grids))

    cell_ddl = options.cell_deadline_s
    if cell_ddl and not _alarm_usable():
        _note_deadline_unenforced(rec, kind, deadline_s=cell_ddl)

    def _attempt(idxs: List[int], key: str, attempts: int, fail: dict):
        """One subgroup with its retries: ``(outs, wall, delta,
        retries_used)``, or the last attempt's :class:`_Failure` (its wall
        and counters left in ``fail`` for the quarantine record)."""
        group = [cells[i] for i in idxs]
        ddl = cell_ddl * len(group) if cell_ddl else None
        for attempt in range(1, attempts + 1):
            t0 = time.perf_counter()
            counters0 = _trecorder.process_counters()
            try:
                with soft_deadline(ddl):
                    outs = runner(group, key)
            except Exception as e:  # noqa: BLE001 - every failure degrades
                failure = _failed(e)
            else:
                return outs, time.perf_counter() - t0, counter_delta(counters0), attempt - 1
            fail["wall"] = time.perf_counter() - t0
            fail["delta"] = counter_delta(counters0)
            if attempt == attempts:
                break
            delay = backoff_delay(attempt, options.base_delay_s, options.max_delay_s)
            _emit_retry(rec, report, kind,
                        what="sweep_group" if len(group) > 1 else "sweep_cell",
                        attempt=attempt, delay=delay, failure=failure, batch=key,
                        cell=group[0].label if len(group) == 1 else None)
            options.sleep(delay)
        return failure

    def _commit(idxs, outs, wall, delta, key, retries_used):
        share = wall / len(idxs)
        exec_share = max(0.0, wall - delta.get("compile_s", 0.0)) / len(idxs)
        for j, (i, out) in enumerate(zip(idxs, outs)):
            c = cells[i]
            results[i] = out
            walls[i] = share
            # journal first: a crash between the two runs the cell again on
            # resume; the other order would mark it done with no result
            if journal is not None:
                journal.record(c.label, out, wall_s=share)
            if sweep is not None:
                extra = {"retries": retries_used} if retries_used else {}
                sweep.record(c.label, share, counter_delta=delta if j == 0 else None,
                             execute_s=round(exec_share, 6), batch=key, batch_size=len(idxs),
                             **extra)
        report.executed += len(idxs)

    def _solve(idxs: List[int], key: str, attempts: int):
        fail: dict = {}
        done = _attempt(idxs, key, attempts, fail)
        if not isinstance(done, _Failure):
            _commit(idxs, *done[:3], key, done[3])
            return
        if len(idxs) == 1:
            _quarantine_cell(rec, sweep, journal, report, kind, cells[idxs[0]].label, done,
                             attempts=attempts, batch=key, wall=fail.get("wall", 0.0),
                             delta=fail.get("delta"))
            return
        # bisect: the halves get one attempt (the transient budget is
        # spent), a single cell the whole budget before its quarantine
        report.degraded_groups += 1
        mid = len(idxs) // 2
        for half in (idxs[:mid], idxs[mid:]):
            _solve(half, key, options.attempts if len(half) == 1 else 1)

    progressed = 0
    for key, idxs in plan_groups(cells):
        pending: List[int] = []
        for i in idxs:
            c = cells[i]
            if journal is not None and journal.has(c.label):
                results[i], walls[i] = _recover_cell(journal, sweep, report, c.label, batch=key)
            else:
                pending.append(i)
        if not pending:
            continue
        # group-boundary preemption, after one group of new work
        if report.preempted or (progressed and options.should_yield is not None
                                and options.should_yield()):
            report.preempted = True
            continue
        _solve(pending, key, options.attempts)
        progressed += 1

    return results, walls, report
