"""The service's worker pool: spawn, frames, liveness, group kill, replace.

Counterpart: ``blades_tpu/service/workers.py``. The mechanics of the pool;
its policy (what to dispatch, when a deadline has passed, how a dead
worker's request is salvaged) is ``SimulationService._work_pool`` in
``service/server.py``. One :class:`WorkerPool` owns W
:class:`WorkerHandle` s, each a ``python -m
blades_tpu_torch.service.worker --out DIR --device D`` child:

- **spawn**: ``start_new_session=True``, so each worker is a process group
  of its own that :func:`~blades_tpu_torch.supervision.supervisor
  .kill_process_group` (SIGTERM, SIGCONT, grace, SIGKILL, then a
  ``/proc`` scan for survivors) reaps with whatever it started, never
  signalling the server's group. Every worker gets the pool's ``device``:
  a pool of ``cuda`` workers spawns no CPU worker. A worker's stderr
  appends to ``<out>/workers/<wid>.err``.
- **frames**: one reader thread per worker puts its stdout frames on one
  queue that the dispatch loop polls; every frame is a liveness beat
  (``last_event_ts``), and EOF puts a ``_eof`` frame, so a dead worker is
  found at the next poll.
- **deadlines**: a worker's ``cell_start`` frame arms ``cell_label`` /
  ``cell_start_ts`` / ``cell_cells`` on its handle; the server's
  enforcement compares ``now - cell_start_ts`` with ``cell_deadline_s x
  cell_cells`` plus a slack and calls :meth:`WorkerPool.kill`: the
  deadline SIGALRM cannot keep inside a kernel or a synchronize.
- **replace**: a killed or dead worker's slot respawns at once
  (``restarts`` counts them); its warmth dies with the process, so the
  replacement is cold, and the scheduler's per-worker warm routing knows.
- **shutdown**: ``shutdown`` frames first, then a group kill of any
  straggler, then a ``/proc`` scan of every group the pool ever spawned:
  zero survivors.

Stdlib only: a pool of probe-only workers runs in a server that never
imports torch.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from blades_tpu_torch.service.worker import WORKER_ID_ENV
from blades_tpu_torch.supervision.supervisor import kill_process_group, list_group

__all__ = ["WorkerHandle", "WorkerPool"]


class WorkerHandle:
    """One worker child and what the dispatch loop tracks of it."""

    def __init__(self, wid: str, proc: subprocess.Popen, pgid: int):
        self.wid = wid
        self.proc = proc
        self.pgid = pgid
        self.state = "spawning"  # -> idle -> busy -> dead
        self.spawned_ts = time.time()
        self.last_event_ts = self.spawned_ts
        #: the request in flight (a ScheduledRequest), its assignment time
        #: and its parent-side ledger entry
        self.entry: Any = None
        self.assigned_ts: Optional[float] = None
        self.ledger: Any = None
        #: the execution unit running (armed by a cell_start frame, cleared
        #: by its sweep record) and its effective per-cell deadline
        self.cell_label: Optional[str] = None
        self.cell_cells: int = 1
        self.cell_start_ts: Optional[float] = None
        self.cell_deadline_s: Optional[float] = None
        self.cells_done = 0
        self.served = 0
        #: affinity fingerprints this process has run (the scheduler's
        #: per-worker warm routing; they die with the process)
        self.warm: Set[str] = set()

    def clear_assignment(self) -> None:
        self.entry = None
        self.assigned_ts = None
        self.ledger = None
        self.cell_label = None
        self.cell_cells = 1
        self.cell_start_ts = None
        self.cell_deadline_s = None

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = now if now is not None else time.time()
        out: Dict[str, Any] = {"state": self.state, "pid": self.proc.pid,
                               "cells_done": self.cells_done, "served": self.served,
                               "warm": len(self.warm)}
        if self.entry is not None:
            out["request"] = getattr(self.entry, "request_id", None)
            if self.assigned_ts is not None:
                out["request_age_s"] = round(now - self.assigned_ts, 3)
        if self.cell_label is not None and self.cell_start_ts is not None:
            out["cell"] = self.cell_label
            out["cell_age_s"] = round(now - self.cell_start_ts, 3)
        return out


class WorkerPool:
    """W supervised worker processes and one frame queue (see the module
    docstring). ``device`` is every worker's ``--device``;
    ``term_grace_s`` / ``kill_wait_s`` size the SIGTERM to SIGKILL
    escalation, short by default: a worker the parent kills is hung or
    dead, and its journaled cells are already on disk."""

    def __init__(self, size: int, out_dir: str, device: str = "cuda",
                 term_grace_s: float = 2.0, kill_wait_s: float = 10.0):
        self.size = int(size)
        self.out_dir = out_dir
        self.device = str(device)
        self.term_grace_s = float(term_grace_s)
        self.kill_wait_s = float(kill_wait_s)
        self.workers: Dict[str, WorkerHandle] = {}
        self.events: "queue.Queue[Tuple[str, Dict[str, Any]]]" = queue.Queue()
        self.restarts = 0
        self.kills = 0
        self._spawned_pgids: Set[int] = set()
        self._seq = 0
        os.makedirs(os.path.join(out_dir, "workers"), exist_ok=True)

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        for _ in range(self.size):
            self.spawn()

    def spawn(self) -> WorkerHandle:
        wid = f"w{self._seq}"
        self._seq += 1
        env = dict(os.environ)
        env[WORKER_ID_ENV] = wid
        err = open(os.path.join(self.out_dir, "workers", f"{wid}.err"), "ab")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "blades_tpu_torch.service.worker",
                 "--out", self.out_dir, "--device", self.device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, env=env,
                start_new_session=True, text=True, bufsize=1,
            )
        finally:
            err.close()  # the child holds its own descriptor
        try:
            pgid = os.getpgid(proc.pid)
        except OSError:
            pgid = proc.pid
        handle = WorkerHandle(wid, proc, pgid)
        self.workers[wid] = handle
        self._spawned_pgids.add(pgid)
        threading.Thread(target=self._read, args=(handle,), name=f"worker-reader-{wid}",
                         daemon=True).start()
        return handle

    def replace(self, wid: str) -> WorkerHandle:
        """Respawn a dead worker's slot: the dead handle is dropped, and the
        health surface reports live slots and lifetime restarts."""
        self.workers.pop(wid, None)
        self.restarts += 1
        return self.spawn()

    def _read(self, handle: WorkerHandle) -> None:
        stdout = handle.proc.stdout
        assert stdout is not None
        try:
            for line in stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # a torn frame must not end the reader
                self.events.put((handle.wid, ev))
        except (OSError, ValueError):
            pass  # the pipe closed under a kill
        self.events.put((handle.wid, {"ev": "_eof"}))

    # -- messaging -------------------------------------------------------------

    def send(self, wid: str, msg: Dict[str, Any]) -> bool:
        handle = self.workers.get(wid)
        if handle is None or handle.proc.stdin is None:
            return False
        try:
            handle.proc.stdin.write(json.dumps(msg, default=str) + "\n")
            handle.proc.stdin.flush()
            return True
        except (OSError, ValueError):
            return False  # a dead pipe: the _eof frame brings the news

    def wake(self) -> None:
        """End the dispatch loop's wait at once (a request was admitted):
        otherwise an idle pool dispatches only when its poll times out."""
        self.events.put(("", {"ev": "_wake"}))

    def poll(self, timeout: float) -> List[Tuple[str, Dict[str, Any]]]:
        """Every queued ``(wid, frame)``, waiting up to ``timeout`` for the
        first; stamps the handles' liveness."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        try:
            out.append(self.events.get(timeout=max(0.0, timeout)))
        except queue.Empty:
            return out
        while True:
            try:
                out.append(self.events.get_nowait())
            except queue.Empty:
                break
        now = time.time()
        for wid, _ in out:
            handle = self.workers.get(wid)
            if handle is not None:
                handle.last_event_ts = now
        return out

    # -- introspection ---------------------------------------------------------

    def idle(self) -> List[WorkerHandle]:
        return [h for h in self.workers.values() if h.state == "idle"]

    def busy(self) -> List[WorkerHandle]:
        return [h for h in self.workers.values() if h.state == "busy"]

    def snapshot(self) -> Dict[str, Any]:
        """The ``workers`` block of ``op: status``, ``op: metrics`` and the
        ``service`` health record: size, busy and idle counts, lifetime
        restarts and kills, and each worker's state with the age of its
        running cell, so a hung worker shows on this surface alone."""
        now = time.time()
        # a copy: the listener thread reads while the dispatch loop replaces
        workers = dict(self.workers)
        return {
            "size": self.size,
            "busy": sum(1 for h in workers.values() if h.state == "busy"),
            "idle": sum(1 for h in workers.values() if h.state == "idle"),
            "restarts": self.restarts,
            "kills": self.kills,
            "by_worker": {wid: h.snapshot(now) for wid, h in sorted(workers.items())},
        }

    # -- kill / shutdown -------------------------------------------------------

    def kill(self, wid: str) -> Dict[str, Any]:
        """Group-kill one worker (the supervisor's SIGTERM to SIGKILL
        escalation); returns its ``{"pgid", "escalated", "survivors"}``. The
        handle goes ``dead``; the caller salvages its request and calls
        :meth:`replace`."""
        handle = self.workers.get(wid)
        if handle is None:
            return {"pgid": None, "escalated": False, "survivors": []}
        self.kills += 1
        info = kill_process_group(handle.proc, term_grace_s=self.term_grace_s,
                                  kill_wait_s=self.kill_wait_s)
        handle.state = "dead"
        self._close_pipes(handle)
        return info

    def _close_pipes(self, handle: WorkerHandle) -> None:
        for fh in (handle.proc.stdin, handle.proc.stdout):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass

    def orphans(self) -> List[int]:
        """Live pids in any process group this pool ever spawned (a
        ``/proc`` scan, zombies left out): the zero-orphans measurement."""
        pids: List[int] = []
        for pgid in self._spawned_pgids:
            pids.extend(list_group(pgid))
        return pids

    def shutdown(self, timeout: float = 10.0) -> Dict[str, Any]:
        """Ask every live worker to exit, wait, group-kill the stragglers,
        and check that nothing survives."""
        for wid in list(self.workers):
            self.send(wid, {"op": "shutdown"})
        deadline = time.monotonic() + max(0.0, timeout)
        for handle in self.workers.values():
            if handle.state == "dead":
                continue
            try:
                handle.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                kill_process_group(handle.proc, term_grace_s=self.term_grace_s,
                                   kill_wait_s=self.kill_wait_s)
                self.kills += 1
            handle.state = "dead"
            self._close_pipes(handle)
        survivors = self.orphans()
        for pid in survivors:
            # nothing this pool spawned may outlive it
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        return {"restarts": self.restarts, "kills": self.kills, "survivors": survivors}
