"""One worker process of the service's pool: a request's blast radius.

Counterpart: ``blades_tpu/service/worker.py``. Spawned by
:class:`~blades_tpu_torch.service.workers.WorkerPool` in a process group
of its own (``python -m blades_tpu_torch.service.worker --out DIR
--device cuda``), the worker keeps a private
:class:`~blades_tpu_torch.sweeps.EngineCache` and dataset cache, and runs
the requests its parent assigns over an NDJSON pipe protocol, the JAX
package's wire format:

- **parent to worker** (stdin): ``{"op": "assign", "id", "request",
  "options"}`` runs one request; ``{"op": "yield"}`` asks the resilient
  executor to stop at the next cell boundary (the scheduler's preemption,
  relayed; the reader thread handles it, since the main thread is busy
  executing); ``{"op": "shutdown"}`` or EOF exits.
- **worker to parent** (stdout): ``{"ev": "ready"}`` once started;
  ``{"ev": "cell_start", "label", "cells"}`` before every attempt, on
  which the parent arms the cell's deadline; ``{"ev": "record", "type",
  "fields"}`` for each trace record the executor writes (the parent
  writes it to the one service trace); ``{"ev": "done", "id", "reply",
  ...}`` with the reply the in-process path builds and the worker's build
  counters' delta (the parent's warm or cold comes from it: the parent
  builds nothing).

The deadline is **external** (``ResilienceOptions(deadline="external")``):
no SIGALRM here. A cell that hangs, in a kernel or a synchronize where an
alarm could not reach it, stops sending frames; the parent kills this
process group and runs the journaled remainder on a replacement. Every
finished cell is in the request's
:class:`~blades_tpu_torch.sweeps.journal.SweepJournal` (the in-process
executor's path) before it is reported, so the replacement runs only the
rest.

Two rules are the port's own:

- **The worker takes ``--device``** (``cuda`` by default), the server's,
  for its ``simulate`` cells and sweeps. A ``cuda`` worker without CUDA
  fails those cells as the in-process server does
  (``core/engine.py:resolve_device`` raises); it never runs them on the
  CPU.
- **A dead CUDA context ends the worker.** When the executor raises
  ``DeviceLost`` (an attempt failed and the device then failed its
  probe), the worker sends no ``done`` frame and exits with
  :data:`DEVICE_LOST_EXIT`. Its parent takes that for a crash: it reaps
  the worker, requeues the request and runs its journaled remainder on a
  fresh worker with a fresh context. A worker with a dead context never
  stays in the pool, where it would fail every later request.

The protocol channel is a duplicate of the original stdout; fd 1 then
points at stderr before any request runs, so a library's print never
breaks the framing. Module scope is stdlib and the port's torch-free
telemetry: a worker that serves only probe requests never imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from blades_tpu_torch.telemetry import context as _context
from blades_tpu_torch.telemetry import reqpath as _reqpath

__all__ = ["main", "WORKER_ID_ENV", "DEVICE_LOST_EXIT"]

#: Set by the pool at spawn: this worker's id ("w0", "w1", ...).
WORKER_ID_ENV = "BLADES_WORKER_ID"

#: The exit code of a worker whose CUDA context died.
DEVICE_LOST_EXIT = 3


class _DeviceLost(Exception):
    """The executor's ``DeviceLost``, carried to :func:`main`, which ends
    the process."""


class _Pipe:
    """The worker's half of the protocol: one locked writer over the
    duplicated stdout (the executor's record frames and the main loop's
    ``done`` frames must never interleave)."""

    def __init__(self, fh):
        self._fh = fh
        self._lock = threading.Lock()

    def send(self, ev: Dict[str, Any]) -> None:
        line = json.dumps(ev, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()


class _ForwardingRecorder:
    """The executor's recorder: every record (retry, quarantine, resume,
    sweep) becomes a ``record`` frame, written through at once."""

    def __init__(self, pipe: _Pipe):
        self._pipe = pipe

    def event(self, type_: str, **fields) -> None:
        self._pipe.send({"ev": "record", "type": type_, "fields": fields})

    def flush(self) -> None:
        pass


class _WorkerAccounting:
    """The worker's side of the server's ``_RequestAccounting``: the same
    ``sweep`` and ``resume`` records, sent as ``record`` frames; the parent
    writes them, counts the cell and beats the heartbeat."""

    kind = "service"

    def __init__(self, pipe: _Pipe, request_id: str, total: int):
        self.rec = _ForwardingRecorder(pipe)
        self.request_id = request_id
        self.total = int(total)
        self.done = 0

    def record(self, key: str, wall_s: float,
               counter_delta: Optional[Dict[str, Any]] = None, **fields) -> None:
        error = fields.pop("error", None)
        error_type = fields.pop("error_type", None)
        delta = dict(counter_delta or {})
        self.done += 1
        rec_fields: Dict[str, Any] = {
            "sweep": self.kind,
            "cell": f"{self.request_id}/{key}",
            "ts": time.time(),
            "i": self.done,
            "total": self.total,
            "wall_s": round(float(wall_s), 6),
            "execute_s": round(max(0.0, wall_s - delta.get("compile_s", 0.0)), 6),
            **delta,
            **fields,
        }
        if error is not None:
            rec_fields["ok"] = False
            rec_fields["error"] = str(error)[:300]
            if error_type is not None:
                rec_fields.setdefault("error_type", error_type)
        self.rec.event("sweep", **rec_fields)

    def resume(self, skipped: int, journal: Optional[str] = None,
               quarantined: int = 0) -> None:
        fields: Dict[str, Any] = {"sweep": self.kind, "skipped": int(skipped),
                                  "total": self.total, "ts": time.time()}
        if quarantined:
            fields["quarantined"] = int(quarantined)
        if journal:
            fields["journal"] = str(journal)
        self.rec.event("resume", **fields)


def _execute(rid: str, request: Dict[str, Any], opts: Dict[str, Any],
             state: Dict[str, Any], pipe: _Pipe,
             yield_flag: threading.Event) -> Dict[str, Any]:
    """One request through the resilient executor, the worker's side of
    the server's ``_execute`` without the bookkeeping the parent keeps
    (the request's path, ledger, counters, spool and reply). Returns the
    ``done`` frame's body; raises only :class:`_DeviceLost`."""
    from blades_tpu_torch.service import handlers as _handlers
    from blades_tpu_torch.sweeps import EngineCache, program_fingerprint
    from blades_tpu_torch.sweeps.journal import SweepJournal
    from blades_tpu_torch.sweeps.resilient import DeviceLost, ResilienceOptions

    t0 = time.perf_counter()
    if state.get("cache") is None:
        state["cache"] = EngineCache()
    cache = state["cache"]
    # the process counters with the cache's build totals, as the
    # in-process server takes them (telemetry/reqpath.py:build_counters)
    counters0 = _reqpath.build_counters(cache)

    def _counters() -> Dict[str, Any]:
        after = _reqpath.build_counters(cache)
        return {k: after.get(k, 0) - counters0.get(k, 0) for k in set(after) | set(counters0)}

    def _error(e: Exception, **extra) -> Dict[str, Any]:
        error = f"{type(e).__name__}: {e}"[:300]
        return {"id": rid, "reply": {"ok": False, "id": rid, "status": "error",
                                     "error": error},
                **extra, "wall_s": round(time.perf_counter() - t0, 6),
                "counters": _counters()}

    ctx = {"cache": cache, "datasets": state["datasets"], "device": state["device"],
           "out_dir": state["out_dir"], "request_id": rid}
    try:
        plan = _handlers.build_plan(request, ctx)
    except Exception as e:  # noqa: BLE001 - an error reply, as in-process
        return _error(e)
    labels = plan.labels
    # the in-process executor's journal: whatever ended the previous
    # attempt, a worker's death included, this one recovers its cells
    journal = SweepJournal(
        os.path.join(state["out_dir"], "requests", rid, "journal.jsonl"),
        fingerprint=program_fingerprint(request={k: v for k, v in request.items()
                                                 if k != "id"}),
        resume=True,
    )
    resumed_pre = sum(1 for lab in labels if journal.has(lab))
    acct = _WorkerAccounting(pipe, rid, total=len(labels))
    opt_kw: Dict[str, Any] = {
        "attempts": int(opts.get("attempts", 2)),
        "base_delay_s": float(opts.get("base_delay_s", 0.5)),
        "cell_deadline_s": opts.get("cell_deadline_s"),
    }
    opt_kw.update(plan.resilience_kw or {})
    # the parent enforces the deadline by killing this process group: no
    # SIGALRM here, and no deadline_unenforced record
    opt_kw["deadline"] = "external"
    opt_kw["should_yield"] = yield_flag.is_set
    # the frame carries the effective deadline (a plan's override included)
    cell_ddl = opt_kw.get("cell_deadline_s")
    opt_kw["on_cell_start"] = lambda label, cells: pipe.send({
        "ev": "cell_start", "id": rid, "label": label, "cells": int(cells),
        "ts": time.time(), **({"deadline_s": float(cell_ddl)} if cell_ddl else {}),
    })
    options = ResilienceOptions(**opt_kw)
    try:
        results, walls, report = plan.execute(sweep=acct, journal=journal, options=options)
        if report.preempted:
            return {"id": rid,
                    "reply": {"ok": True, "id": rid, "status": "preempted",
                              "executed": report.executed},
                    "report": report.summary(), "preempted": True,
                    "resumed_pre": resumed_pre, "cells": len(labels),
                    "wall_s": round(time.perf_counter() - t0, 6), "counters": _counters()}
        extra = plan.finalize(results, walls, report) if plan.finalize else {}
    except DeviceLost as e:
        raise _DeviceLost(str(e)) from e
    except Exception as e:  # noqa: BLE001 - isolation: reply, don't die
        return _error(e, resumed_pre=resumed_pre, cells=len(labels))
    finally:
        journal.close()
    quarantined = {q["cell"]: q for q in report.quarantined}
    out_cells = []
    for label, res in zip(labels, results):
        if res is None:
            q = quarantined.get(label, {})
            out_cells.append({"label": label, "quarantined": True,
                              "error": q.get("error", "quarantined"),
                              "error_type": q.get("error_type", "Exception")})
        elif plan.slim_cells:
            out_cells.append({"label": label})
        else:
            out_cells.append({"label": label, "result": res})
    return {
        "id": rid,
        "reply": {"ok": not quarantined, "id": rid, "status": "done",
                  "kind": request.get("kind"), "cells": out_cells,
                  "summary": report.summary(), **extra},
        "report": report.summary(),
        "resumed_pre": resumed_pre,
        "cells": len(labels),
        "wall_s": round(time.perf_counter() - t0, 6),
        "counters": _counters(),
        "cache": cache.stats(),
    }


def _reader(stdin, inbox, yield_flag: threading.Event) -> None:
    """Parent frames into the inbox; ``yield`` is handled here, since the
    main thread is executing when a preemption arrives."""
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except ValueError:
            continue  # a torn frame is the parent's problem
        if msg.get("op") == "yield":
            yield_flag.set()
        else:
            inbox.put(msg)
    inbox.put(None)  # EOF: the parent is gone


def main(argv=None) -> int:
    import queue as _queue

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="the service's --out directory (the requests' journals)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where simulate cells and sweeps run (default cuda)")
    args = p.parse_args(argv)

    # the protocol channel is a duplicate of stdout; fd 1 then points at
    # stderr, so a stray print never breaks the framing
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    _context.activate()  # the parent's run id and attempt (environment)
    pipe = _Pipe(proto)
    yield_flag = threading.Event()
    inbox: Any = _queue.Queue()
    threading.Thread(target=_reader, args=(sys.stdin, inbox, yield_flag),
                     name="worker-reader", daemon=True).start()

    state: Dict[str, Any] = {"cache": None, "datasets": {}, "out_dir": args.out,
                             "device": args.device}
    pipe.send({"ev": "ready", "worker": os.environ.get(WORKER_ID_ENV), "pid": os.getpid(),
               "pgid": os.getpgid(0)})
    while True:
        msg = inbox.get()
        if msg is None or msg.get("op") == "shutdown":
            break
        if msg.get("op") != "assign":
            continue
        rid = str(msg.get("id"))
        yield_flag.clear()  # a stale yield must not preempt a fresh request
        try:
            done = _execute(rid, msg.get("request") or {}, msg.get("options") or {},
                            state, pipe, yield_flag)
        except _DeviceLost as e:
            # no done frame: the parent reaps this worker as a crash and
            # runs the journaled remainder on a fresh one. os._exit, since
            # the interpreter's teardown may hang on a dead context
            sys.stderr.write(f"worker {os.environ.get(WORKER_ID_ENV)}: DeviceLost: {e}\n")
            sys.stderr.flush()
            os._exit(DEVICE_LOST_EXIT)
        pipe.send({"ev": "done", **done})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
