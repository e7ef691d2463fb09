"""The simulation service: one warm server process answering requests
over a unix socket, with request-level fault isolation and a crash-safe
resume.

Counterpart: ``blades_tpu/service/server.py`` (``SimulationService``,
its worker pool ``_work_pool`` and what it drives at :1016-1486, and
``serve``'s pool branch at :1577-1590). With ``workers=0`` one process, two
threads:

- the **listener** thread accepts connections, answers ``ping``,
  ``status``, ``result``, ``metrics`` and ``drain`` itself, and admits
  ``submit``: the spool's durable append
  (:class:`~blades_tpu_torch.service.spool.RequestSpool`) first, then the
  scheduler (``service/scheduler.py``), ``rejected: backpressure`` past
  ``max_queue`` or a tenant's quota. It never touches torch or the card.
- the thread that called :meth:`SimulationService.serve`, the main
  thread, runs one request at a time through the resilient ladder
  (:func:`~blades_tpu_torch.sweeps.resilient.run_cells_resilient`): the
  per-cell SIGALRM soft deadline, retries with backoff, quarantine of a
  poison cell. All CUDA work of a ``simulate`` cell or a sweep runs here.
  Between cells a lower-priority request yields to a higher one
  (``should_yield``) and is requeued; its journal resumes it.

With ``workers=N > 0`` requests run in N worker processes
(``service/worker.py``, ``service/workers.py``), each a process group of
its own on the server's ``device``, and the main thread keeps the
server's books (paths, ledger, spool, replies, the one trace): it
dispatches (a worker first takes a request it is warm for), writes the
workers' records, and enforces each cell's deadline by killing the
worker's process group when the cell outlives ``cell_deadline_s x
cells + DEADLINE_SLACK_S`` (no SIGALRM anywhere; a kill reaches a kernel
or a synchronize). A worker that dies or is killed mid-request is
replaced, and its request is requeued: the replacement recovers the
journaled cells and runs the rest, so the reply equals an undisturbed
run's. After ``attempts`` deaths in one cell the parent quarantines the
cell in the journal itself. A worker whose CUDA context died exits
without a reply (``service/worker.py``) and is salvaged the same way. The
parent never imports torch.

**SIGTERM** (or ``op: drain``) stops admission, finishes everything
admitted, replies, and exits 0. After **SIGKILL** a relaunch under
``BLADES_RESUME=1`` (``python -m blades_tpu_torch.supervision``) requeues
the spool's pending requests; each request's
:class:`~blades_tpu_torch.sweeps.journal.SweepJournal` recovers its
finished cells and only the rest run, so the reply a client fetches
(``op: result``) equals an uninterrupted run's.

The server beats ``BLADES_HEARTBEAT_FILE`` at every cell and on idle
ticks. Each request gets a run-ledger entry (``telemetry/ledger.py``), and
``<out>/service_trace.jsonl`` holds the ``service``, ``request``,
per-cell ``sweep``, ``metrics_snapshot`` and ``cache_stats`` records of
the trace schema (``telemetry/telemetry_schema.json``), which the JAX
package's ``scripts/sweep_status.py`` and ``scripts/runs.py --run-id``
read. Each request's wall is split into queue wait, build and execute
(``telemetry/reqpath.py``): build is what the engine cache, ``nvcc`` and
CUDA-graph captures recorded during the request; a request that paid none
is warm. Under the pool these counters are the worker's: its ``done``
frame carries their delta, since the parent builds nothing.

Module scope is stdlib plus the port's torch-free telemetry, spool,
scheduler and heartbeat modules: a server that serves only probe cells
never imports torch.
"""

from __future__ import annotations

import os
import signal
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from blades_tpu_torch.service import protocol as _protocol
from blades_tpu_torch.service import scheduler as _scheduler
from blades_tpu_torch.service.handlers import (  # stdlib at module scope
    estimate_cells,
    safe_name,
)
from blades_tpu_torch.service.spool import RequestSpool
from blades_tpu_torch.supervision import heartbeat as _heartbeat
from blades_tpu_torch.telemetry import Recorder
from blades_tpu_torch.telemetry import context as _context
from blades_tpu_torch.telemetry import ledger as _ledger
from blades_tpu_torch.telemetry import reqpath as _reqpath

__all__ = ["SimulationService", "TRACE_NAME"]

#: The service's telemetry trace filename inside its --out directory.
TRACE_NAME = "service_trace.jsonl"

#: Spool filename inside the --out directory.
SPOOL_NAME = "spool.jsonl"

#: Grace the parent adds to a cell's budget before it kills the worker:
#: it sees the cell only at its poll cadence and must not kill a worker
#: that would have finished within the budget it was promised.
DEADLINE_SLACK_S = 1.0


class _LockedRecorder(Recorder):
    """The service trace's recorder, made thread-safe: the listener thread
    (admission and reject records) and the executing thread (cell and
    request records, the resilient executor's retry flushes) share it, and
    an unlocked flush race would interleave torn lines."""

    def __init__(self, *a, **kw):
        self._lock = threading.RLock()
        super().__init__(*a, **kw)

    def _emit(self, record):
        with self._lock:
            super()._emit(record)

    def flush(self):
        with self._lock:
            super().flush()


class _RequestAccounting:
    """Per-cell accounting for one request: the ``sweep=`` adapter the
    resilient executor drives. Emits one schema-locked ``sweep`` record
    per cell (``sweep: "service"``, cell key ``<request_id>/<label>``,
    i-of-N within the request), flushes at the cell boundary, and beats
    the supervision heartbeat — a supervised server stays visibly alive
    through a long request exactly like a sweep driver does."""

    kind = "service"

    def __init__(self, svc: "SimulationService", request_id: str, total: int):
        self._svc = svc
        self.rec = svc.rec
        self.request_id = request_id
        self.total = int(total)
        self.done = 0

    def record(
        self,
        key: str,
        wall_s: float,
        counter_delta: Optional[Dict[str, Any]] = None,
        **fields,
    ) -> None:
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
            "execute_s": round(
                max(0.0, wall_s - delta.get("compile_s", 0.0)), 6,
            ),
            **delta,
            **fields,
        }
        if error is not None:
            rec_fields["ok"] = False
            rec_fields["error"] = str(error)[:300]
            if error_type is not None:
                rec_fields.setdefault("error_type", error_type)
        self.rec.event("sweep", **rec_fields)
        self.rec.flush()
        self._svc.metrics.cell(self.request_id)
        self._svc._beat()

    def resume(self, skipped: int, journal: Optional[str] = None,
               quarantined: int = 0) -> None:
        """A journaled resume within THIS request (a preempted slice or
        a crash relaunch): same ``resume`` record the sweep drivers emit
        (``telemetry/timeline.py``), keyed ``sweep: "service"`` — a
        driver routed through the service (the ``sweep`` request kind)
        reports its recovery on the service trace too."""
        fields: Dict[str, Any] = {
            "sweep": self.kind,
            "skipped": int(skipped),
            "total": self.total,
            "ts": time.time(),
        }
        if quarantined:
            fields["quarantined"] = int(quarantined)
        if journal:
            fields["journal"] = str(journal)
        self.rec.event("resume", **fields)
        self.rec.flush()


class SimulationService:
    """One warm server process (see the module docstring).

    Parameters
    ----------
    out_dir : the service directory: the socket (by default), the spool,
        the trace, the per-request journals and log directories.
    socket_path : the unix socket's path (default ``<out>/service.sock``).
    max_queue : the admission bound on queued requests (the one in flight
        excluded); past it ``rejected: backpressure`` names the deepest
        tenant (``service/scheduler.py``).
    tenant_quota : a per-tenant queue bound (default ``None``: the global
        bound only).
    attempts / base_delay_s / cell_deadline_s : the resilient ladder's
        settings (:class:`~blades_tpu_torch.sweeps.resilient
        .ResilienceOptions`); the deadline is a cell's.
    health_interval_s : the cadence of idle ``service`` health records.
    resume : requeue the spool's pending requests before accepting new
        ones; by default read from ``BLADES_RESUME``.
    workers : the worker-process pool's size. ``0`` (the default) runs
        requests in the main thread (SIGALRM deadlines, one at a time);
        ``N > 0`` spawns N workers on ``device``, the parent enforcing each
        cell's deadline by a group kill and salvaging a dead worker's
        request (the module docstring).
    device : where ``simulate`` cells and sweeps run, ``"cuda"`` (the
        default) or ``"cpu"``; probe cells touch no device.
    """

    def __init__(
        self,
        out_dir: str,
        socket_path: Optional[str] = None,
        max_queue: int = 8,
        tenant_quota: Optional[int] = None,
        attempts: int = 2,
        base_delay_s: float = 0.5,
        cell_deadline_s: Optional[float] = None,
        health_interval_s: float = 30.0,
        poll_s: float = 0.5,
        resume: Optional[bool] = None,
        workers: int = 0,
        device: str = "cuda",
    ):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.socket_path = _protocol.socket_path_for(out_dir, socket_path)
        self.max_queue = int(max_queue)
        self.tenant_quota = tenant_quota
        self.attempts = int(attempts)
        self.base_delay_s = float(base_delay_s)
        self.cell_deadline_s = cell_deadline_s
        self.health_interval_s = float(health_interval_s)
        self.poll_s = float(poll_s)
        self.workers = int(workers)
        self.device = str(device)
        #: the worker pool (service/workers.py), made in serve() when
        #: workers > 0; None on the in-process path
        self._pool = None
        #: (request id, cell label) -> worker deaths in it so far; at
        #: `attempts` the parent quarantines the cell (a cell that kills
        #: every worker must not respawn workers forever)
        self._kills: Dict[Tuple[str, str], int] = {}
        if resume is None:
            resume = os.environ.get(_heartbeat.RESUME_ENV) == "1"
        self.resume = bool(resume)

        self.ctx = _context.activate()
        trace = os.path.join(out_dir, TRACE_NAME)
        if not self.resume:
            # a fresh service lifetime is a new trace; a resumed one
            # APPENDS — one continuous trail across attempts
            try:
                os.unlink(trace)
            except OSError:
                pass
        self.rec = _LockedRecorder(
            path=trace,
            meta={"run": "service", "socket": self.socket_path,
                  "max_queue": self.max_queue},
        )
        self.rec.flush()  # the trace must be queryable before any request
        self.spool = RequestSpool(
            os.path.join(out_dir, SPOOL_NAME), resume=self.resume
        )

        # the warm caches the service exists to keep: engines (the cache is
        # made on the first request's execution; a probe-only server never
        # builds one) and datasets, shared by every request of the process
        self._engine_cache = None
        self._datasets: Dict[Any, Any] = {}

        #: the multi-tenant scheduler (service/scheduler.py): priority
        #: classes, weighted per-tenant fairness, per-tenant quotas,
        #: warm-first placement
        self._sched = _scheduler.TenantScheduler(
            max_queue=self.max_queue, tenant_quota=self.tenant_quota,
        )
        self._draining = threading.Event()
        self._drain_reason: Optional[str] = None
        self._state_lock = threading.Lock()
        self._pending_ts: Dict[str, float] = {}  # id -> admit time
        self._in_flight: Optional[str] = None
        self._in_flight_since: Optional[float] = None
        #: rolling request-path metrics (telemetry/reqpath.py): the
        #: `op: metrics` reply body and the periodic `metrics_snapshot`
        #: trace record both read from it
        self.metrics = _reqpath.MetricsRegistry()
        #: deadline-aware admission (scheduler.py CostEstimator): cost
        #: from the rolling split and the cache's per-fingerprint builds
        self._estimator = _scheduler.CostEstimator(
            self.metrics.snapshot, self._cache_stats,
        )
        self.served = 0
        self.rejected = 0
        self.quarantined_requests = 0
        self.failed = 0
        self.resumed_requests = 0
        self.preemptions = 0
        self.cells_done = 0
        self._t0 = time.monotonic()
        self._last_health = 0.0
        self._sock: Optional[socket.socket] = None
        self._listener: Optional[threading.Thread] = None
        self._stop_listening = False

    # -- shared emitters -------------------------------------------------------

    def event(self, type_: str, **fields) -> None:
        """Emit one service-trace record and flush it (a live status probe
        reads every service event)."""
        self.rec.event(type_, ts=time.time(), **fields)
        self.rec.flush()

    def _beat(self) -> None:
        self.cells_done += 1
        _heartbeat.beat(round_idx=self.cells_done)

    def _build_counters(self) -> Dict[str, float]:
        """The process's build counters with the engine cache's build
        totals: a request that moved none of them is warm
        (``telemetry/reqpath.py:build_counters``)."""
        return _reqpath.build_counters(self._engine_cache)

    def _cache_stats(self) -> Optional[Dict[str, Any]]:
        """The engine cache's stats, or None before the first build (the
        estimator's injectable history source)."""
        cache = self._engine_cache
        return cache.stats() if cache is not None else None

    def _snapshot(self) -> Dict[str, Any]:
        with self._state_lock:
            pending = dict(self._pending_ts)
            in_flight = self._in_flight
            in_flight_since = self._in_flight_since
        now = time.time()
        oldest = min(pending.values(), default=None)
        pool = self._pool
        pool_block: Dict[str, Any] = {}
        in_flight_count = 1 if in_flight else 0
        if pool is not None:
            wsnap = pool.snapshot()
            pool_block["workers"] = wsnap
            # under the pool the busy workers are in flight; the id and age
            # shown are the oldest assignment's
            busy = [h for h in list(pool.workers.values())
                    if h.state == "busy" and h.entry is not None and h.assigned_ts is not None]
            if busy:
                oldest_busy = min(busy, key=lambda h: h.assigned_ts)
                in_flight = getattr(oldest_busy.entry, "request_id", None)
                in_flight_since = oldest_busy.assigned_ts
            in_flight_count = wsnap["busy"]
        return {
            "queue_depth": self._sched.qsize(),
            # per-class depths + per-tenant composition: a starved (or
            # flooding) tenant is attributable from the status surface,
            # and a drained batch queue cannot mask a backed-up
            # interactive one
            "queue_by_class": self._sched.depth_by_class(),
            "tenants": self._sched.composition(),
            "preemptions": self.preemptions,
            "in_flight": in_flight_count,
            # the in-flight request's identity and age, not a bare 0/1:
            # a wedged request must be attributable from this surface
            **(
                {"in_flight_id": in_flight,
                 "in_flight_age_s": round(now - in_flight_since, 3)}
                if in_flight and in_flight_since is not None
                else {}
            ),
            **pool_block,
            "served": self.served,
            "rejected": self.rejected,
            "quarantined_requests": self.quarantined_requests,
            "failed": self.failed,
            "resumed": self.resumed_requests,
            "oldest_pending_age_s": (
                round(now - oldest, 3) if oldest is not None else None
            ),
            "draining": self._draining.is_set(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "pid": os.getpid(),
            "run_id": self.ctx.run_id,
        }

    def _health(self, event: str = "health") -> None:
        snap = self._snapshot()
        self.event(
            "service",
            event=event,
            queue_depth=snap["queue_depth"],
            queue_by_class=snap["queue_by_class"],
            preemptions=snap["preemptions"],
            **({"tenants": snap["tenants"]} if snap["tenants"] else {}),
            in_flight=snap["in_flight"],
            served=snap["served"],
            rejected=snap["rejected"],
            quarantined_requests=snap["quarantined_requests"],
            draining=snap["draining"],
            uptime_s=snap["uptime_s"],
            **(
                {"oldest_pending_age_s": snap["oldest_pending_age_s"]}
                if snap["oldest_pending_age_s"] is not None
                else {}
            ),
            **{
                k: snap[k]
                for k in ("in_flight_id", "in_flight_age_s")
                if k in snap
            },
            # the pool's block rides every service record: a hung worker
            # (its cell's age growing) or a restart storm shows in the trace
            **({"workers": snap["workers"]} if "workers" in snap else {}),
        )
        # the rolling serving metrics ride the same cadence: one
        # schema-locked snapshot record per health beat, so queue-wait
        # share / warm p99 are queryable from the trace of a LIVE (or
        # dead) server, not just over the socket
        self.event("metrics_snapshot", **self.metrics.snapshot())
        # the engine cache's per-fingerprint stats ride the same beat
        # (hits, misses, build seconds, last use per EngineCache key); no
        # record before the first request makes the cache
        if self._engine_cache is not None:
            self.event("cache_stats", **self._engine_cache.stats())
        self._last_health = time.monotonic()

    # -- listener --------------------------------------------------------------

    def _listen(self) -> None:
        assert self._sock is not None
        while not self._stop_listening:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                # the accept timeout is the stop-flag poll: closing the
                # socket from the executing thread does NOT reliably wake a
                # blocked accept on Linux, so a drain would otherwise
                # stall until the join timeout
                continue
            except OSError:
                return  # socket closed by serve()'s exit path
            try:
                conn.settimeout(10.0)  # a mute client must not wedge accept
                self._handle_conn(conn)
            except Exception:  # noqa: BLE001 - one bad conn never kills serve
                try:
                    conn.close()
                except OSError:
                    pass

    def _reply_and_close(self, f, conn, payload: Dict[str, Any]) -> None:
        try:
            _protocol.write_message(f, payload)
        except OSError:
            pass  # client gone; the spool still holds anything durable
        finally:
            try:
                f.close()
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _handle_conn(self, conn) -> None:
        f = conn.makefile("rwb")
        try:
            msg = _protocol.read_message(f)
        except _protocol.ProtocolError as e:
            self._reply_and_close(f, conn, {"ok": False, "error": str(e)})
            return
        if msg is None:
            self._reply_and_close(f, conn, {"ok": False, "error": "empty"})
            return
        op = msg.get("op")
        if op == "ping":
            self._reply_and_close(
                f, conn,
                {"ok": True, "pid": os.getpid(), "run_id": self.ctx.run_id},
            )
        elif op == "status":
            self._reply_and_close(f, conn, {"ok": True, **self._snapshot()})
        elif op == "metrics":
            reply = {"ok": True, **self.metrics.snapshot()}
            if self._engine_cache is not None:
                # the per-fingerprint cache stats the `cache_stats`
                # records carry, live over the socket
                reply["engine_cache"] = self._engine_cache.stats()
            if self._pool is not None:
                reply["workers"] = self._pool.snapshot()
            self._reply_and_close(f, conn, reply)
        elif op == "result":
            rid = str(msg.get("id") or "")
            reply = self.spool.reply(rid)
            if reply is not None:
                self._reply_and_close(
                    f, conn, {"ok": True, "status": "done", "reply": reply}
                )
            elif self.spool.has(rid):
                self._reply_and_close(
                    f, conn, {"ok": True, "status": "pending", "id": rid}
                )
            else:
                self._reply_and_close(
                    f, conn, {"ok": True, "status": "unknown", "id": rid}
                )
        elif op == "drain":
            self._drain_reason = "drain_op"
            self._draining.set()
            self._reply_and_close(f, conn, {"ok": True, "draining": True})
        elif op == "submit":
            self._admit(msg, f, conn)
        else:
            self._reply_and_close(
                f, conn, {"ok": False, "error": f"unknown op {op!r}"}
            )

    def _admit(self, msg: Dict[str, Any], f, conn) -> None:
        request = msg.get("request")
        if not isinstance(request, dict):
            self._reply_and_close(
                f, conn, {"ok": False, "error": "submit carries no request"}
            )
            return
        rid = request.get("id")
        if rid:
            try:
                # the id becomes the per-request journal/log dir segment
                # — an unsafe one (path separators, '..') must be
                # rejected at the door, before it is durably spooled
                rid = safe_name(rid, "request id")
            except ValueError as e:
                self._reply_and_close(
                    f, conn, {"ok": False, "error": str(e)}
                )
                return
        else:
            rid = None
        kind = str(request.get("kind"))
        client = request.get("client")
        if client is not None:
            try:
                # tenant labels key the per-client metrics tables; hold
                # them to the same safe charset as ids (they may become
                # path segments once per-tenant scheduling lands)
                client = safe_name(client, "client label")
            except ValueError as e:
                self._reply_and_close(f, conn, {"ok": False, "error": str(e)})
                return
        else:
            client = "anon"
        # idempotent resubmission: a completed id is served from the
        # spool (never re-executed), a pending one is not double-queued
        if rid and self.spool.reply(rid) is not None:
            self._reply_and_close(
                f, conn,
                {"ok": True, "status": "done", "id": rid, "served": "spool",
                 "reply": self.spool.reply(rid)},
            )
            return
        if rid and self.spool.has(rid):
            self._reply_and_close(
                f, conn, {"ok": True, "status": "pending", "id": rid}
            )
            return
        priority = request.get("priority") or "normal"
        try:
            _scheduler.priority_rank(priority)
        except ValueError as e:
            self._reply_and_close(f, conn, {"ok": False, "error": str(e)})
            return
        if self._draining.is_set():
            self.rejected += 1
            self.metrics.reject("draining", op=kind, client=client)
            self.event("service", event="reject", reason="draining",
                        queue_depth=self._sched.qsize())
            self._reply_and_close(
                f, conn,
                {"ok": False, "rejected": "draining",
                 "error": "service is draining; not admitting requests"},
            )
            return
        verdict = self._sched.overflow(client)
        if verdict is not None:
            # admission control: a bounded queue and an explicit reply,
            # load shed instead of absorbed into memory. The verdict NAMES
            # the tenant whose backlog overflowed (its own quota, or the
            # deepest tenant when the global cap trips) so a flooder is
            # attributable and a victim is exonerated from the reject
            # record itself
            self.rejected += 1
            self.metrics.reject("backpressure", op=kind, client=client)
            self.event("service", event="reject", reason="backpressure",
                        queue_depth=self._sched.qsize(),
                        tenant=verdict["tenant"])
            self._reply_and_close(
                f, conn,
                {"ok": False, "rejected": "backpressure",
                 **{k: v for k, v in verdict.items() if k != "reason"}},
            )
            return
        # warm-first affinity: the same request-body fingerprint that
        # guards the per-request journal keys the EngineCache — a repeat
        # body lands where its engines are already built (sweeps imports
        # no torch at module scope)
        from blades_tpu_torch.sweeps import program_fingerprint

        affinity = program_fingerprint(request={
            k: v for k, v in request.items() if k != "id"
        })
        # deadline-aware admission, BEFORE spooling: an infeasible
        # deadline is rejected while rejecting is still cheap — never
        # durably admitted, never executed, never replayed on resume
        deadline_s = request.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
                if deadline_s <= 0:
                    raise ValueError
            except (TypeError, ValueError):
                self._reply_and_close(
                    f, conn,
                    {"ok": False,
                     "error": "deadline_s must be a positive number"},
                )
                return
        n_cells = estimate_cells(request)
        verdict_name, est = self._estimator.verdict(
            n_cells, deadline_s,
            backlog_s=self._sched.backlog_s(priority),
            warm=self._sched.is_warm(affinity),
        )
        if deadline_s is not None:
            self.metrics.admission(verdict_name)
        if verdict_name == "infeasible":
            self.rejected += 1
            self.metrics.reject("deadline_infeasible", op=kind,
                                client=client)
            self.event("service", event="reject",
                        reason="deadline_infeasible",
                        queue_depth=self._sched.qsize(), tenant=client)
            self._reply_and_close(
                f, conn,
                {"ok": False, "rejected": "deadline_infeasible",
                 "est": est},
            )
            return
        # mint the id BEFORE spooling so the lifecycle path can stamp
        # admitted → spooled → queued in true order
        rid = rid or _protocol.mint_request_id()
        path = self.metrics.admit(rid, op=kind, client=client,
                                  priority=priority)
        # spool FIRST, queue second: a crash between the two replays the
        # request on resume; the reverse would acknowledge lost work
        try:
            rid = self.spool.admit(request, request_id=rid)
        except Exception:
            # a failed durable admission must not leak the open path in
            # the registry (a long-lived server must not grow state per
            # request): close it as a failed request, then let the
            # listener's per-connection guard reply/close
            self.metrics.finish(rid, outcome="error")
            raise
        path.stamp("spooled")
        with self._state_lock:
            self._pending_ts[rid] = time.time()
        self.event(
            "request", event="admitted", id=rid,
            kind=kind,
            cells=n_cells,
            client=client, priority=priority,
            **(
                {"admission": verdict_name, "deadline_s": deadline_s,
                 **({"est_s": est["est_s"]} if est else {})}
                if deadline_s is not None else {}
            ),
        )
        waiter = (f, conn) if msg.get("wait", True) else None
        self._sched.put(_scheduler.ScheduledRequest(
            request_id=rid, request=request, waiter=waiter,
            tenant=client, priority=priority, affinity=affinity,
            est_s=(est or {}).get("est_s"),
        ))
        if waiter is None:
            self._reply_and_close(
                f, conn, {"ok": True, "status": "accepted", "id": rid}
            )
        path.stamp("queued")
        if self._pool is not None:
            # the port's own: an idle pool dispatches now, not at its next
            # poll timeout (poll_s, 0.5 s of a warm request's wait)
            self._pool.wake()
        self.metrics.queue_depth(self._sched.qsize(),
                                 by_class=self._sched.depth_by_class())

    # -- execution -------------------------------------------------------------

    def _execute(
        self,
        rid: str,
        request: Dict[str, Any],
        sched_entry: Optional["_scheduler.ScheduledRequest"] = None,
    ) -> Dict[str, Any]:
        """One request through the resilient ladder; returns the reply.
        Never raises — a failure to even build the request becomes an
        ``error`` reply, not a dead server. With a ``sched_entry``, the
        ladder yields at cell boundaries when strictly-higher-priority
        work waits (the reply's ``status`` becomes ``"preempted"`` and
        _work requeues the entry — the journal makes the next slice
        resume content-identically)."""
        # the ladder's modules import no torch at module scope (the
        # simulate runner and the drivers import it when they run), so a
        # probe-only server never loads torch
        from blades_tpu_torch.service import handlers as _handlers
        from blades_tpu_torch.sweeps import program_fingerprint
        from blades_tpu_torch.sweeps.journal import SweepJournal
        from blades_tpu_torch.sweeps.resilient import ResilienceOptions

        t0 = time.perf_counter()
        with self._state_lock:
            admit_ts = self._pending_ts.get(rid)
        queue_age = time.time() - admit_ts if admit_ts else None
        # request-path accounting: reuse the path the listener opened at
        # admission (its queue-wait covers the real wait); direct callers
        # (tests, chip_smoke.py) get a fresh one with zero wait
        path = self.metrics.get(rid)
        if path is None:
            path = self.metrics.admit(
                rid, op=str(request.get("kind")),
                client=str(request.get("client") or "anon"),
            )
        # the cache exists before the plan is built (sweep plans capture
        # it: chaos cells share engines across requests) and before the
        # path starts (its build totals are part of the start's counters)
        if self._engine_cache is None:
            from blades_tpu_torch.sweeps import EngineCache

            self._engine_cache = EngineCache()
        path.start(counters=self._build_counters())
        entry = _ledger.run_started(
            "request",
            config={
                "id": rid,
                "kind": request.get("kind"),
                "cells": len(request.get("cells") or []),
            },
        )
        ctx = {
            "cache": self._engine_cache,
            "datasets": self._datasets,
            "device": self.device,
            "out_dir": self.out_dir,
            "request_id": rid,
        }
        try:
            plan = _handlers.build_plan(request, ctx)
        except Exception as e:  # noqa: BLE001 - an error reply, never a dead server
            self.failed += 1
            error = f"{type(e).__name__}: {e}"[:300]
            self.event("request", event="finished", id=rid,
                        outcome="error", error=error,
                        wall_s=round(time.perf_counter() - t0, 6),
                        **self.metrics.finish(
                            rid, outcome="error",
                            counters=self._build_counters()))
            entry.ended("crashed", error=error)
            return {"ok": False, "id": rid, "status": "error",
                    "error": error}
        labels = plan.labels
        self.event(
            "request", event="started", id=rid,
            kind=str(request.get("kind")), cells=len(labels),
            **({"queue_age_s": round(queue_age, 3)}
               if queue_age is not None else {}),
        )
        # per-request journal: completed cells survive SIGKILL (and a
        # preemption — a requeued slice resumes from it); the
        # fingerprint guard keys on the request body, so a resumed id
        # whose spooled body somehow drifted starts clean instead of
        # stitching two different requests into one reply
        journal = SweepJournal(
            os.path.join(self.out_dir, "requests", rid, "journal.jsonl"),
            fingerprint=program_fingerprint(request={
                k: v for k, v in request.items() if k != "id"
            }),
            resume=True,
        )
        resumed_cells = sum(1 for lab in labels if journal.has(lab))
        if resumed_cells:
            self.resumed_requests += 1
        acct = _RequestAccounting(self, rid, total=len(labels))
        opt_kw: Dict[str, Any] = {
            "attempts": self.attempts,
            "base_delay_s": self.base_delay_s,
            "cell_deadline_s": self.cell_deadline_s,
        }
        opt_kw.update(plan.resilience_kw or {})
        if sched_entry is not None:
            # cell-boundary preemption: the ladder polls between cells;
            # strictly-higher-priority waiting work wins the slot
            prio = sched_entry.priority
            opt_kw["should_yield"] = (
                lambda: self._sched.waiting_above(prio)
            )
        options = ResilienceOptions(**opt_kw)
        try:
            results, walls, report = plan.execute(
                sweep=acct, journal=journal, options=options,
            )
            if report.preempted:
                wall = time.perf_counter() - t0
                self.event(
                    "request", event="preempted", id=rid,
                    kind=str(request.get("kind")), cells=len(labels),
                    executed=report.executed,
                    resumed_cells=report.resumed_skipped,
                    preemptions=(sched_entry.preemptions + 1
                                 if sched_entry else 1),
                    wall_s=round(wall, 6),
                )
                entry.ended("finished", metrics={
                    "preempted": 1, "executed": report.executed,
                })
                # the lifecycle path stays OPEN: the next slice re-calls
                # path.start() (first-wins stamps keep the true start)
                # and metrics.finish closes it when the request is done
                return {"ok": True, "id": rid, "status": "preempted",
                        "executed": report.executed}
            extra = (
                plan.finalize(results, walls, report)
                if plan.finalize else {}
            )
        except Exception as e:  # noqa: BLE001 - isolation: reply, don't die
            self.failed += 1
            error = f"{type(e).__name__}: {e}"[:300]
            self.event("request", event="finished", id=rid,
                        outcome="error", error=error,
                        wall_s=round(time.perf_counter() - t0, 6),
                        **self.metrics.finish(
                            rid, outcome="error",
                            counters=self._build_counters()))
            entry.ended("crashed", error=error)
            return {"ok": False, "id": rid, "status": "error",
                    "error": error}
        finally:
            journal.close()
        quarantined = {q["cell"]: q for q in report.quarantined}
        out_cells: List[Dict[str, Any]] = []
        for label, res in zip(labels, results):
            if res is None:
                q = quarantined.get(label, {})
                out_cells.append({
                    "label": label,
                    "quarantined": True,
                    "error": q.get("error", "quarantined"),
                    "error_type": q.get("error_type", "Exception"),
                })
            elif plan.slim_cells:
                # driver plans (certify/chaos) return their result via
                # finalize()'s assembled artifact; per-cell payloads
                # would bloat the spooled reply with redundant rows
                out_cells.append({"label": label})
            else:
                out_cells.append({"label": label, "result": res})
        wall = time.perf_counter() - t0
        outcome = "quarantined" if quarantined else "ok"
        if quarantined:
            self.quarantined_requests += 1
        self.served += 1
        client = path.client
        priority = path.priority
        # close the lifecycle path: the finished record carries the
        # queue-wait / build / execute split (it tiles total_s) and the
        # warm/cold classification alongside the execution wall
        split = self.metrics.finish(
            rid, outcome=outcome, retried=report.retried,
            quarantined_cells=len(quarantined),
            counters=self._build_counters(),
        )
        self.event(
            "request", event="finished", id=rid, outcome=outcome,
            cells=len(labels), executed=report.executed,
            resumed_cells=report.resumed_skipped,
            quarantined=len(quarantined), retried=report.retried,
            client=client, priority=priority,
            **(
                {"preemptions": sched_entry.preemptions}
                if sched_entry is not None and sched_entry.preemptions
                else {}
            ),
            wall_s=round(wall, 6),
            **split,
        )
        entry.ended("finished", metrics={
            "cells": len(labels),
            "executed": report.executed,
            "resumed_cells": report.resumed_skipped,
            "quarantined": len(quarantined),
            "retried": report.retried,
        })
        return {
            "ok": not quarantined,
            "id": rid,
            "status": "done",
            "kind": request.get("kind"),
            "cells": out_cells,
            "summary": report.summary(),
            **extra,
        }

    def _work(self) -> Dict[str, Any]:
        while True:
            entry_obj = self._sched.pick(timeout=self.poll_s)
            if entry_obj is None:
                self._beat_idle()
                if self._draining.is_set() and self._sched.empty():
                    # zero-lost-requests on drain needs ordering, not
                    # luck: a listener mid-_admit may have passed its
                    # draining check and be about to spool+queue one
                    # more request. Stop the listener FIRST (close the
                    # socket, join the thread — bounded by the conn
                    # timeout), then re-check: anything it managed to
                    # admit is in the queue now and loops back into
                    # execution; only a truly empty queue exits.
                    self._shutdown_listener()
                    if self._sched.empty():
                        break
                continue
            rid = entry_obj.request_id
            request = entry_obj.request
            with self._state_lock:
                self._in_flight = rid
                self._in_flight_since = time.time()
            slice_t0 = time.monotonic()
            reply = self._execute(rid, request, sched_entry=entry_obj)
            # fair-share charges the tenant for the slice it actually
            # consumed — a preempted slice still cost its wall
            self._sched.charge(entry_obj.tenant,
                               time.monotonic() - slice_t0)
            if reply.get("status") == "preempted":
                # the request is NOT done: requeue it (same seq — it
                # keeps its place among equals), keep the spool entry
                # pending and the waiter riding on the entry. The
                # higher-priority work that triggered the yield is
                # picked next.
                self.preemptions += 1
                self.metrics.preempted(rid)
                with self._state_lock:
                    self._in_flight = None
                    self._in_flight_since = None
                self._sched.requeue(entry_obj)
                self.metrics.queue_depth(
                    self._sched.qsize(),
                    by_class=self._sched.depth_by_class(),
                )
                continue
            # warm-first bookkeeping: this body's engines are now built;
            # a repeat body is scheduled as warm by the estimator
            self._sched.note_warm(entry_obj.affinity)
            self._sched.done(entry_obj)
            # spool before replying: the reply must be fetchable (op:
            # result) even if the waiting client died with the connection
            self.spool.complete(rid, reply)
            with self._state_lock:
                self._in_flight = None
                self._in_flight_since = None
                self._pending_ts.pop(rid, None)
            if entry_obj.waiter is not None:
                f, conn = entry_obj.waiter
                self._reply_and_close(f, conn, reply)
            self._health()
        return self._snapshot()

    # -- worker pool -------------------------------------------------------------
    #
    # The pooled _work (JAX :1016-1486): requests run in worker processes
    # (service/worker.py); the parent keeps every book (paths, ledger,
    # spool, replies, the one trace) and enforces each cell's deadline by
    # killing the worker's process group. A dead or killed worker's request
    # is requeued, and the replacement recovers its journaled cells.

    def _work_pool(self) -> Dict[str, Any]:
        pool = self._pool
        assert pool is not None
        try:
            while True:
                self._dispatch(pool)
                for wid, ev in pool.poll(self.poll_s):
                    self._on_worker_event(pool, wid, ev)
                self._enforce_deadlines(pool)
                self._maybe_yield(pool)
                # the parent beats every tick: a hung worker stalls one
                # request, never the server's own heartbeat
                self._beat_idle()
                if self._draining.is_set() and self._sched.empty() and not pool.busy():
                    # the race-free drain exit of _work: stop the listener
                    # first, then check again
                    self._shutdown_listener()
                    if self._sched.empty() and not pool.busy():
                        break
        finally:
            info = pool.shutdown()
            self.event("worker", event="pool_shutdown", restarts=info["restarts"],
                       kills=info["kills"], survivors=info["survivors"])
        return self._snapshot()

    def _dispatch(self, pool) -> None:
        """Fill the idle workers: first each takes a request it is warm for
        (the per-worker affinity: a repeat goes back to the process holding
        its engines), then any still idle takes the scheduler's next."""
        for handle in pool.idle():
            entry = self._sched.pick(0, worker=handle.wid, warm_only=True)
            if entry is not None:
                self._assign(pool, handle, entry)
        for handle in pool.idle():
            entry = self._sched.pick(0, worker=handle.wid)
            if entry is None:
                break
            self._assign(pool, handle, entry)

    def _assign(self, pool, handle, entry) -> None:
        rid = entry.request_id
        request = entry.request
        with self._state_lock:
            admit_ts = self._pending_ts.get(rid)
        queue_age = time.time() - admit_ts if admit_ts else None
        path = self.metrics.get(rid)
        if path is None:
            path = self.metrics.admit(rid, op=str(request.get("kind")),
                                      client=str(request.get("client") or "anon"))
        # a zero baseline: the parent builds nothing, so the worker's
        # reported delta is the request's whole build work
        path.start(counters={})
        handle.entry = entry
        handle.assigned_ts = time.time()
        handle.state = "busy"
        handle.ledger = _ledger.run_started("request", config={
            "id": rid, "kind": request.get("kind"),
            "cells": len(request.get("cells") or [])})
        self.event("request", event="started", id=rid, kind=str(request.get("kind")),
                   cells=estimate_cells(request), worker=handle.wid,
                   **({"queue_age_s": round(queue_age, 3)} if queue_age is not None else {}))
        self.event("worker", event="assign", worker=handle.wid, request=rid)
        # a dead pipe leaves the entry on the handle: the reader's _eof
        # frame reaps and salvages at the next poll
        pool.send(handle.wid, {"op": "assign", "id": rid, "request": request,
                               "options": {"attempts": self.attempts,
                                           "base_delay_s": self.base_delay_s,
                                           "cell_deadline_s": self.cell_deadline_s}})

    def _on_worker_event(self, pool, wid: str, ev: Dict[str, Any]) -> None:
        handle = pool.workers.get(wid)
        kind = ev.get("ev")
        if kind == "ready":
            if handle is not None and handle.state == "spawning":
                handle.state = "idle"
            self.event("worker", event="ready", worker=wid, pid=ev.get("pid"),
                       pgid=ev.get("pgid"))
        elif kind == "cell_start":
            # the worker's per-attempt beat arms this unit's deadline
            if handle is not None:
                handle.cell_label = str(ev.get("label"))
                handle.cell_cells = max(1, int(ev.get("cells") or 1))
                handle.cell_start_ts = time.time()
                ddl = ev.get("deadline_s")
                handle.cell_deadline_s = (float(ddl) if ddl else
                                          float(self.cell_deadline_s) if self.cell_deadline_s
                                          else None)
        elif kind == "record":
            # the workers' records go to the one service trace
            type_ = str(ev.get("type"))
            self.rec.event(type_, **dict(ev.get("fields") or {}))
            self.rec.flush()
            if type_ == "sweep" and handle is not None:
                if handle.entry is not None:
                    self.metrics.cell(handle.entry.request_id)
                self._beat()
                handle.cells_done += 1
                # a grouped unit keeps the rest of its budget; the last
                # cell disarms, so a slow finalize is never killed
                if handle.cell_start_ts is not None:
                    if handle.cell_cells > 1:
                        handle.cell_cells -= 1
                        handle.cell_start_ts = time.time()
                    else:
                        handle.cell_label = None
                        handle.cell_start_ts = None
                        handle.cell_cells = 1
        elif kind == "done":
            if handle is not None:
                self._finish_worker(pool, handle, ev)
        elif kind == "_eof":
            if handle is None or handle.state == "dead":
                return  # the echo of our own kill, already salvaged
            self._reap_worker(pool, wid, deadline_kill=False,
                              reason="worker process exited unexpectedly",
                              error_type="WorkerCrashed",
                              error="worker process exited unexpectedly mid-request")

    def _finish_worker(self, pool, handle, ev: Dict[str, Any]) -> None:
        entry = handle.entry
        if entry is None:
            return  # a stray done (it raced a kill): nothing to book
        rid = entry.request_id
        wid = handle.wid
        wall = float(ev.get("wall_s") or 0.0)
        reply = dict(ev.get("reply") or {})
        counters = dict(ev.get("counters") or {})
        report = dict(ev.get("report") or {})
        ledger_entry = handle.ledger
        # fair share charges the wall the worker spent
        self._sched.charge(entry.tenant, wall)
        if entry.affinity:
            handle.warm.add(entry.affinity)
        handle.clear_assignment()
        handle.state = "idle"
        handle.served += 1
        if ev.get("preempted"):
            self.preemptions += 1
            self.metrics.preempted(rid)
            self.event("request", event="preempted", id=rid,
                       kind=str(entry.request.get("kind")), cells=int(ev.get("cells") or 0),
                       executed=int(report.get("executed") or 0),
                       resumed_cells=int(report.get("resumed_skipped") or 0),
                       preemptions=entry.preemptions + 1, wall_s=round(wall, 6), worker=wid)
            if ledger_entry is not None:
                ledger_entry.ended("finished", metrics={
                    "preempted": 1, "executed": int(report.get("executed") or 0)})
            self._sched.requeue(entry)
            self.metrics.queue_depth(self._sched.qsize(), by_class=self._sched.depth_by_class())
            return
        for key in [k for k in self._kills if k[0] == rid]:
            self._kills.pop(key, None)
        if reply.get("status") == "error":
            self.failed += 1
            error = str(reply.get("error") or "error")[:300]
            self.event("request", event="finished", id=rid, outcome="error", error=error,
                       wall_s=round(wall, 6), worker=wid,
                       **self.metrics.finish(rid, outcome="error", counters=counters))
            if ledger_entry is not None:
                ledger_entry.ended("crashed", error=error)
        else:
            if int(ev.get("resumed_pre") or 0):
                self.resumed_requests += 1
            quarantined_cells = len(report.get("quarantined") or [])
            retried = int(report.get("retried") or 0)
            outcome = "quarantined" if quarantined_cells else "ok"
            if quarantined_cells:
                self.quarantined_requests += 1
            self.served += 1
            path = self.metrics.get(rid)
            client = path.client if path is not None else "anon"
            priority = path.priority if path is not None else "normal"
            # the worker's counter delta closes the path: warm or cold and
            # the build split come from the process that built
            split = self.metrics.finish(rid, outcome=outcome, retried=retried,
                                        quarantined_cells=quarantined_cells, counters=counters)
            self.event(
                "request", event="finished", id=rid, outcome=outcome,
                cells=int(ev.get("cells") or 0), executed=int(report.get("executed") or 0),
                resumed_cells=int(report.get("resumed_skipped") or 0),
                quarantined=quarantined_cells, retried=retried, client=client,
                priority=priority,
                **({"preemptions": entry.preemptions} if entry.preemptions else {}),
                wall_s=round(wall, 6), worker=wid, **split)
            if ledger_entry is not None:
                ledger_entry.ended("finished", metrics={
                    "cells": int(ev.get("cells") or 0),
                    "executed": int(report.get("executed") or 0),
                    "resumed_cells": int(report.get("resumed_skipped") or 0),
                    "quarantined": quarantined_cells, "retried": retried})
            # per-worker warmth: a repeat of this body goes to this process
            self._sched.note_warm(entry.affinity, worker=wid)
            if ev.get("cache"):
                self.event("worker", event="done", worker=wid, request=rid,
                           served=handle.served, cells_done=handle.cells_done,
                           cache=ev.get("cache"))
        self._sched.done(entry)
        self.spool.complete(rid, reply)
        with self._state_lock:
            self._pending_ts.pop(rid, None)
        if entry.waiter is not None:
            f, conn = entry.waiter
            self._reply_and_close(f, conn, reply)
        self._health()

    def _reap_worker(self, pool, wid: str, *, deadline_kill: bool, reason: str,
                     error_type: str, error: str) -> None:
        """Kill (or bury) one worker, salvage its request, respawn its
        slot; ``forget_worker`` drops the dead process's warmth (its
        EngineCache died with it)."""
        handle = pool.workers.get(wid)
        if handle is None or handle.state == "dead":
            return
        cell = handle.cell_label
        age = time.time() - handle.cell_start_ts if handle.cell_start_ts is not None else None
        info = pool.kill(wid)
        self.event("worker", event="kill" if deadline_kill else "crash", worker=wid,
                   pid=handle.proc.pid, reason=reason, escalated=bool(info.get("escalated")),
                   survivors=list(info.get("survivors") or []),
                   **({"request": handle.entry.request_id} if handle.entry is not None else {}),
                   **({"cell": cell} if cell else {}),
                   **({"age_s": round(age, 3)} if age is not None else {}))
        if handle.entry is not None:
            self._salvage(handle, error=error, error_type=error_type)
        dropped = self._sched.forget_worker(wid)
        replacement = pool.replace(wid)
        self.event("worker", event="replace", worker=replacement.wid,
                   pid=replacement.proc.pid, restarts=pool.restarts,
                   **({"dropped_warm": dropped} if dropped else {}))

    def _salvage(self, handle, *, error: str, error_type: str) -> None:
        """A worker died holding a request: charge the slice, count the
        death against the cell it died in, requeue. The journaled cells
        are on disk: the replacement runs the rest, and the reply equals an
        undisturbed run's. At ``attempts`` deaths in one cell the parent
        quarantines it in the journal; a worker that keeps dying before
        any cell starts fails the request."""
        entry = handle.entry
        rid = entry.request_id
        cell = handle.cell_label
        if handle.assigned_ts is not None:
            self._sched.charge(entry.tenant, time.time() - handle.assigned_ts)
        if handle.ledger is not None:
            handle.ledger.ended("crashed", error=error)
        key = (rid, cell if cell is not None else "__build__")
        kills = self._kills.get(key, 0) + 1
        self._kills[key] = kills
        if kills >= self.attempts:
            self._kills.pop(key, None)
            if cell is not None:
                self._parent_quarantine(rid, entry.request, cell, error, error_type,
                                        attempts=kills)
            else:
                handle.clear_assignment()
                self._request_failed(entry, error=(
                    f"{error_type}: worker died {kills}x before any cell started ({error})"))
                return
        handle.clear_assignment()
        self._sched.requeue(entry, preempted=False)
        self.metrics.queue_depth(self._sched.qsize(), by_class=self._sched.depth_by_class())

    def _parent_quarantine(self, rid: str, request: Dict[str, Any], label: str, error: str,
                           error_type: str, attempts: int) -> None:
        """Quarantine one cell in the request's journal from the parent, as
        the in-process executor would after its attempts; the replacement
        recovers the quarantine and goes past the cell."""
        from blades_tpu_torch.sweeps import program_fingerprint
        from blades_tpu_torch.sweeps.journal import SweepJournal

        journal = SweepJournal(
            os.path.join(self.out_dir, "requests", rid, "journal.jsonl"),
            fingerprint=program_fingerprint(request={k: v for k, v in request.items()
                                                     if k != "id"}),
            resume=True,
        )
        try:
            if not journal.has(label):
                journal.record_quarantine(label, error, error_type, attempts=attempts)
        finally:
            journal.close()
        # the executor's quarantine record
        self.event("quarantine", sweep="service", cell=label, error=error,
                   error_type=error_type, attempts=attempts)

    def _request_failed(self, entry, *, error: str) -> None:
        """A failure the parent decides (a worker dead before any cell, its
        attempts spent): an error reply, the books closed, the waiter
        answered, as on the in-process error path."""
        rid = entry.request_id
        self.failed += 1
        error = error[:300]
        reply = {"ok": False, "id": rid, "status": "error", "error": error}
        self.event("request", event="finished", id=rid, outcome="error", error=error,
                   **self.metrics.finish(rid, outcome="error"))
        self._sched.done(entry)
        self.spool.complete(rid, reply)
        with self._state_lock:
            self._pending_ts.pop(rid, None)
        if entry.waiter is not None:
            f, conn = entry.waiter
            self._reply_and_close(f, conn, reply)

    def _enforce_deadlines(self, pool) -> None:
        """The deadline without SIGALRM: a busy worker whose armed unit has
        outlived ``deadline x cells + DEADLINE_SLACK_S`` is group-killed.
        SIGALRM waits for a kernel or a synchronize to return; a kill does
        not, and only this request pays."""
        now = time.time()
        for handle in list(pool.busy()):
            if handle.cell_start_ts is None or handle.cell_deadline_s is None:
                continue
            budget = handle.cell_deadline_s * max(1, handle.cell_cells) + DEADLINE_SLACK_S
            age = now - handle.cell_start_ts
            if age <= budget:
                continue
            label = handle.cell_label
            self._reap_worker(pool, handle.wid, deadline_kill=True, reason="deadline",
                              error_type="CellDeadlineExceeded",
                              error=(f"cell {label!r} exceeded its parent-enforced deadline "
                                     f"({age:.1f}s > {budget:.1f}s budget)"))

    def _maybe_yield(self, pool) -> None:
        """The preemption, relayed: when higher-priority work waits and no
        worker is idle, each busy worker running lower-priority work is
        asked to yield at its next cell boundary (sent every tick while it
        holds)."""
        if pool.idle():
            return
        for handle in pool.busy():
            entry = handle.entry
            if entry is not None and self._sched.waiting_above(entry.priority):
                pool.send(handle.wid, {"op": "yield"})

    def _shutdown_listener(self) -> None:
        """Stop accepting: close the socket and join the listener thread
        (idempotent). After this returns, no new request can enter the
        queue — the drain exit check is race-free."""
        if self._stop_listening:
            return
        self._stop_listening = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.join(timeout=30.0)

    def _beat_idle(self) -> None:
        # an idle supervised server is healthy, not hung: beat without
        # advancing the cell counter
        _heartbeat.beat(round_idx=self.cells_done)
        if time.monotonic() - self._last_health > self.health_interval_s:
            self._health()

    # -- lifecycle -------------------------------------------------------------

    def serve(self) -> Dict[str, Any]:
        """Run until drained (SIGTERM or ``op: drain``); returns the final
        snapshot. Call from the main thread — the per-cell soft deadline
        and the SIGTERM drain handler both need it."""
        prev_term = prev_int = None
        if threading.current_thread() is threading.main_thread():
            def _drain_signal(signum, frame):
                self._drain_reason = signal.Signals(signum).name
                self._draining.set()

            prev_term = signal.signal(signal.SIGTERM, _drain_signal)
            prev_int = signal.signal(signal.SIGINT, _drain_signal)

        ledger_entry = _ledger.run_started(
            "service",
            config={
                "kind": "service",
                "max_queue": self.max_queue,
                "attempts": self.attempts,
                "cell_deadline_s": self.cell_deadline_s,
                "workers": self.workers,
            },
            artifacts=[
                os.path.join(self.out_dir, TRACE_NAME),
                self.spool.path,
            ],
        )
        # resume BEFORE listening: the interrupted lifetime's requests go
        # to the head of the queue, then new admissions line up behind
        pending = self.spool.pending() if self.resume else []
        if pending:
            from blades_tpu_torch.sweeps import program_fingerprint
        for rid, request in pending:
            with self._state_lock:
                self._pending_ts[rid] = time.time()
            try:
                client = safe_name(request.get("client") or "anon",
                                   "client label")
            except ValueError:
                client = "anon"
            priority = request.get("priority") or "normal"
            if priority not in _scheduler.PRIORITIES:
                priority = "normal"
            # a resumed request's lifecycle restarts at the relaunch:
            # queue-wait measures THIS attempt's wait, not the outage
            path = self.metrics.admit(
                rid, op=str(request.get("kind")), client=client,
                priority=priority,
            )
            path.stamp("spooled")
            self._sched.put(_scheduler.ScheduledRequest(
                request_id=rid, request=request, waiter=None,
                tenant=client, priority=priority,
                affinity=program_fingerprint(request={
                    k: v for k, v in request.items() if k != "id"
                }),
            ))
            path.stamp("queued")
        self.metrics.queue_depth(self._sched.qsize(),
                                 by_class=self._sched.depth_by_class())
        self.event(
            "service", event="start", socket=self.socket_path,
            queue_depth=self._sched.qsize(),
            resumed=len(pending), pid=os.getpid(),
        )

        if self.workers > 0:
            # the pool before the socket: a worker imports no torch and is
            # ready within an interpreter's start, so the first request
            # does not wait on an empty pool for long
            from blades_tpu_torch.service.workers import WorkerPool

            self._pool = WorkerPool(self.workers, self.out_dir, device=self.device)
            self._pool.start()
            for h in self._pool.workers.values():
                self.event("worker", event="spawn", worker=h.wid, pid=h.proc.pid, pgid=h.pgid)

        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        self._sock.settimeout(self.poll_s)  # see _listen: stop-flag poll
        self._stop_listening = False
        self._listener = threading.Thread(
            target=self._listen, name="service-listener", daemon=True
        )
        self._listener.start()

        outcome = "finished"
        try:
            snap = self._work_pool() if self._pool is not None else self._work()
        except BaseException as e:
            outcome = "crashed"
            ledger_entry.ended("crashed", error=f"{type(e).__name__}: {e}")
            raise
        finally:
            self._stop_listening = True
            try:
                self._sock.close()
            except OSError:
                pass
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass
            if outcome == "finished":
                self.event(
                    "service", event="exit",
                    reason=self._drain_reason or "drain",
                    served=self.served, rejected=self.rejected,
                    quarantined_requests=self.quarantined_requests,
                )
            self.rec.close()
            self.spool.close()
            # restore on EVERY path: a crashed service leaving its drain
            # handlers installed would make every later SIGINT/SIGTERM
            # set a defunct event instead of interrupting the process
            if prev_term is not None:
                signal.signal(signal.SIGTERM, prev_term)
            if prev_int is not None:
                signal.signal(signal.SIGINT, prev_int)
        ledger_entry.ended("finished", metrics={
            "served": self.served,
            "rejected": self.rejected,
            "quarantined_requests": self.quarantined_requests,
            "resumed": self.resumed_requests,
        })
        return snap
