"""Crash-safe on-disk request spool: the service's admission journal.

Counterpart: ``blades_tpu/service/spool.py``, copied. The spool is to
requests what :class:`~blades_tpu_torch.sweeps.journal.SweepJournal` is
to cells: one JSON line an event, appended when it happens.

- ``{"kind": "request", "id", "ts", "request": {...}}``, appended before
  the request enters the in-memory queue (spool first, queue second: a
  crash between the two replays the request; the other order would
  acknowledge work that no longer exists);
- ``{"kind": "done", "id", "ts", "reply": {...}}``, the client-visible
  reply, appended when the request completes (after its cell journal
  holds every cell).

A relaunch under ``BLADES_RESUME=1`` loads the spool and requeues every
admitted request without a reply, in admission order; each request's
cell journal recovers its finished cells, so only the rest runs and the
reply equals an uninterrupted run's. A fresh start truncates the spool.
Replies stay fetchable (``op: result``) for the service's lifetime.

Each record is one ``os.write`` on an ``O_APPEND`` descriptor under an
flock (``sweeps/journal.py:_locked_write``). Stdlib only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from blades_tpu_torch.service.protocol import mint_request_id

__all__ = ["RequestSpool"]


class RequestSpool:
    """Append-only request/reply spool with resume.

    ``resume=False`` (a fresh service start) truncates any existing
    spool; ``resume=True`` loads it — admitted requests, completed
    replies — and :meth:`pending` yields what the interrupted lifetime
    still owed.
    """

    def __init__(self, path: str, resume: bool = False):
        self.path = path
        self.resumed = False
        self._requests: Dict[str, Dict[str, Any]] = {}
        self._replies: Dict[str, Dict[str, Any]] = {}
        self._order: List[str] = []
        self._fd: Optional[int] = None
        self._lock = threading.Lock()
        if resume and os.path.exists(path):
            for rec in _load_lines(path):
                rid = rec.get("id")
                if not isinstance(rid, str):
                    continue
                if rec.get("kind") == "request" and "request" in rec:
                    if rid not in self._requests:
                        self._order.append(rid)
                    self._requests[rid] = rec["request"]
                elif rec.get("kind") == "done" and "reply" in rec:
                    self._replies[rid] = rec["reply"]
            self.resumed = bool(self._requests or self._replies)
        if not self.resumed:
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- state ----------------------------------------------------------------

    def has(self, request_id: str) -> bool:
        return request_id in self._requests

    def reply(self, request_id: str) -> Optional[Dict[str, Any]]:
        """The completed reply for one request, or None while pending/
        unknown."""
        return self._replies.get(request_id)

    def pending(self) -> List[Tuple[str, Dict[str, Any]]]:
        """Admitted-but-not-done requests, admission order — what a
        resumed server must re-queue."""
        return [
            (rid, self._requests[rid])
            for rid in self._order
            if rid not in self._replies
        ]

    def counts(self) -> Dict[str, int]:
        return {
            "admitted": len(self._requests),
            "done": len(self._replies),
            "pending": sum(
                1 for r in self._requests if r not in self._replies
            ),
        }

    def __len__(self) -> int:
        return len(self._requests)

    # -- recording ------------------------------------------------------------

    def admit(
        self, request: Dict[str, Any], request_id: Optional[str] = None
    ) -> str:
        """Durably record one admitted request; returns its id. Must be
        called BEFORE the request enters the in-memory queue."""
        rid = request_id or mint_request_id()
        with self._lock:
            if rid not in self._requests:
                self._order.append(rid)
            self._requests[rid] = request
            self._append({
                "kind": "request", "id": rid, "ts": time.time(),
                "request": request,
            })
        return rid

    def complete(self, request_id: str, reply: Dict[str, Any]) -> None:
        """Durably record one request's client-visible reply."""
        with self._lock:
            self._replies[request_id] = reply
            self._append({
                "kind": "done", "id": request_id, "ts": time.time(),
                "reply": reply,
            })

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    # -- internals ------------------------------------------------------------

    def _append(self, rec: Dict[str, Any]) -> None:
        # the sweep journal's whole-line O_APPEND write under a flock: the
        # listener and the executing thread share this descriptor, and a
        # supervisor's relaunch can overlap the last write of the attempt
        # it reaped
        from blades_tpu_torch.sweeps.journal import _locked_write

        if self._fd is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
            )
        _locked_write(self._fd, (json.dumps(rec, default=repr) + "\n").encode())


def _load_lines(path: str) -> List[Dict[str, Any]]:
    """The spool's records, blank and torn lines skipped (a writer killed
    mid-append leaves one torn tail)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out
