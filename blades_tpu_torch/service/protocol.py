"""Service wire protocol: newline-delimited JSON over a unix socket.

Counterpart: ``blades_tpu/service/protocol.py``, copied byte for byte in
what goes over the wire, so the JAX package's client and the port's
server (and the other way round) talk to each other. One message per
line, UTF-8 JSON ending in ``\\n``, at most :data:`MAX_MESSAGE_BYTES`.

Client -> server messages carry an ``op``: ``submit`` (``{"op":
"submit", "request": {...}, "wait": true}``; ``wait: false`` returns
``{"status": "accepted"}`` at once), ``result`` (``{"op": "result",
"id": ...}``: ``done`` / ``pending`` / ``unknown`` from the spool),
``status`` (queue depth, the in-flight request's id and age, served /
rejected / quarantined counts, the oldest pending request's age),
``metrics`` (``telemetry/reqpath.py``), ``drain`` (finish everything
admitted, reply, exit 0) and ``ping``.

A request body is ``{"id", "client", "priority", "deadline_s", "kind":
"probe" | "simulate", "cells": [...]}`` (all but ``kind`` and ``cells``
optional), or ``{"kind": "sweep", "sweep": "certify" | "chaos", "spec":
{...}}`` for the sweep drivers (``service/handlers.py``). An id the spool
holds a reply for is answered from the spool and never runs again.
``client`` is the tenant label (default ``anon``), ``priority`` one of
``interactive`` / ``normal`` (the default) / ``batch``
(``service/scheduler.py``).

Stdlib only: a client, and a server that serves only probe cells, never
import torch.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Dict, Optional

__all__ = [
    "DEFAULT_SOCKET_NAME",
    "MAX_MESSAGE_BYTES",
    "ProtocolError",
    "mint_request_id",
    "read_message",
    "write_message",
]

#: Default socket filename inside the service's --out directory.
DEFAULT_SOCKET_NAME = "service.sock"

#: Hard cap on one encoded message (request payloads are config dicts and
#: result rows, never tensors — 8 MiB is orders of magnitude of headroom).
MAX_MESSAGE_BYTES = 8 * 1024 * 1024


class ProtocolError(Exception):
    """A malformed or oversized wire message."""


def mint_request_id() -> str:
    """A fresh, human-sortable request id (same dialect as run ids)."""
    return (
        "req-"
        + time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        + "-"
        + uuid.uuid4().hex[:8]
    )


def write_message(wfile, obj: Dict[str, Any]) -> None:
    """Encode ``obj`` as one JSON line onto a writable binary file."""
    data = (json.dumps(obj) + "\n").encode()
    if len(data) > MAX_MESSAGE_BYTES:
        raise ProtocolError(
            f"message of {len(data)} bytes exceeds the "
            f"{MAX_MESSAGE_BYTES}-byte cap"
        )
    wfile.write(data)
    wfile.flush()


def read_message(rfile) -> Optional[Dict[str, Any]]:
    """Read one JSON-line message from a readable binary file.

    Returns ``None`` on a cleanly closed peer (EOF before any bytes);
    raises :class:`ProtocolError` on an oversized or unparseable line —
    the server converts that into one error reply, never a crash.
    """
    line = rfile.readline(MAX_MESSAGE_BYTES + 1)
    if not line:
        return None
    if len(line) > MAX_MESSAGE_BYTES:
        raise ProtocolError(
            f"message exceeds the {MAX_MESSAGE_BYTES}-byte cap"
        )
    try:
        obj = json.loads(line.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise ProtocolError(f"unparseable message: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"message must be a JSON object, got {type(obj).__name__}"
        )
    return obj


def socket_path_for(out_dir: str, socket_path: Optional[str] = None) -> str:
    """The service's socket path (default: ``<out>/service.sock``).

    Unix socket paths are length-capped (~108 bytes incl. NUL); a too-deep
    ``out_dir`` fails at bind with a clear error rather than here.
    """
    return socket_path or os.path.join(out_dir, DEFAULT_SOCKET_NAME)
