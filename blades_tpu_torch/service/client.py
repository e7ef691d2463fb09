"""Stdlib-only service client: submit / status / result / drain.

Counterpart: ``blades_tpu/service/client.py``, copied. One connection a
call, one JSON line each way, no state beyond the socket path, so it
imports without torch and a killed server costs it a reconnect. Two loops
carry the crash tolerance:

- :meth:`ServiceClient.request` retries the connect with a bounded
  linear backoff (a refused connection or a missing socket file is what a
  supervisor's relaunch looks like from outside);
- :meth:`ServiceClient.wait_result` polls ``op: result`` until the spool
  holds the reply: the way back for a ``submit`` whose connection died
  with the server.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Dict, Optional

from blades_tpu_torch.service.protocol import (
    ProtocolError,
    read_message,
    write_message,
)

__all__ = ["ServiceClient", "ServiceError"]


class ServiceError(Exception):
    """The server was unreachable (after retries) or broke protocol."""


class ServiceClient:
    """Client for one service socket.

    ``timeout`` bounds each call's socket I/O (a ``submit`` with
    ``wait=True`` blocks for the whole request execution — size it to the
    workload, or submit with ``wait=False`` and poll
    :meth:`wait_result`). ``connect_retries`` x ``connect_delay_s`` is
    the window a relaunching server is given to come back.
    """

    def __init__(
        self,
        socket_path: str,
        timeout: Optional[float] = 60.0,
        connect_retries: int = 5,
        connect_delay_s: float = 0.2,
    ):
        self.socket_path = socket_path
        self.timeout = timeout
        self.connect_retries = max(1, int(connect_retries))
        self.connect_delay_s = connect_delay_s

    # -- transport ------------------------------------------------------------

    def request(
        self, message: Dict[str, Any], timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        """One message -> one reply (fresh connection per call)."""
        timeout = self.timeout if timeout is None else timeout
        last: Optional[Exception] = None
        for attempt in range(1, self.connect_retries + 1):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(timeout)
            try:
                sock.connect(self.socket_path)
            except OSError as e:
                # refused / missing socket file: the supervisor-relaunch
                # window seen from outside — bounded linear backoff
                sock.close()
                last = e
                if attempt < self.connect_retries:
                    time.sleep(self.connect_delay_s * attempt)
                continue
            try:
                f = sock.makefile("rwb")
                try:
                    write_message(f, message)
                    reply = read_message(f)
                finally:
                    f.close()
            except (OSError, ProtocolError) as e:
                last = e
                reply = None
            finally:
                sock.close()
            if reply is not None:
                return reply
            # a dead connection mid-call (server killed while we waited):
            # surface it — the caller decides whether to poll wait_result
            break
        raise ServiceError(
            f"service at {self.socket_path} unreachable: "
            f"{type(last).__name__ if last else 'no reply'}: {last}"
        )

    # -- operations -----------------------------------------------------------

    def ping(self) -> Dict[str, Any]:
        return self.request({"op": "ping"})

    def status(self) -> Dict[str, Any]:
        return self.request({"op": "status"})

    def metrics(self) -> Dict[str, Any]:
        """The rolling serving-metrics snapshot (``telemetry/reqpath.py``):
        latency histograms with p50/p90/p99 (total/warm/cold),
        queue-wait share, per-op and per-client counters, queue-depth
        high-water mark."""
        return self.request({"op": "metrics"})

    def drain(self) -> Dict[str, Any]:
        """Ask the server to finish everything admitted and exit 0."""
        return self.request({"op": "drain"})

    def submit(
        self,
        request: Dict[str, Any],
        request_id: Optional[str] = None,
        wait: bool = True,
        timeout: Optional[float] = None,
        client: Optional[str] = None,
        priority: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Submit one request. ``client`` (tenant label), ``priority``
        (``interactive``/``normal``/``batch``) and ``deadline_s``
        (deadline-aware admission) are conveniences that set the
        corresponding request-body fields when given."""
        msg: Dict[str, Any] = {
            "op": "submit", "request": dict(request), "wait": bool(wait),
        }
        if request_id is not None:
            msg["request"]["id"] = request_id
        if client is not None:
            msg["request"]["client"] = client
        if priority is not None:
            msg["request"]["priority"] = priority
        if deadline_s is not None:
            msg["request"]["deadline_s"] = float(deadline_s)
        return self.request(msg, timeout=timeout)

    def result(self, request_id: str) -> Dict[str, Any]:
        return self.request({"op": "result", "id": request_id})

    def wait_result(
        self,
        request_id: str,
        timeout: float = 120.0,
        poll_s: float = 0.5,
    ) -> Dict[str, Any]:
        """Poll ``op: result`` until the reply exists (the crash-recovery
        fetch). Raises :class:`ServiceError` on deadline or on a server
        that reports the id as unknown (it was never admitted — polling
        longer cannot help)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                reply = self.result(request_id)
            except ServiceError:
                # server mid-relaunch: keep polling until OUR deadline
                reply = None
            if reply is not None:
                if reply.get("status") == "done":
                    return reply
                if reply.get("status") == "unknown":
                    raise ServiceError(
                        f"request {request_id!r} unknown to the service "
                        "(never admitted — not recoverable by waiting)"
                    )
            if time.monotonic() >= deadline:
                raise ServiceError(
                    f"request {request_id!r} still unfinished after "
                    f"{timeout:.1f}s"
                )
            time.sleep(poll_s)
