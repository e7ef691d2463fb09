"""Simulation service: a long-lived, crash-tolerant experiment server.

Counterpart: ``blades_tpu/service/__init__.py`` and its package (``protocol``,
``spool``, ``client``, ``scheduler``, ``handlers``, ``server``,
``worker``, ``workers``). One warm process keeps an
:class:`~blades_tpu_torch.sweeps.EngineCache` and the datasets it built,
and serves requests submitted over a unix socket:

- every request runs through :func:`~blades_tpu_torch.sweeps.resilient
  .run_cells_resilient`: a per-cell soft deadline, retries with backoff,
  quarantine of a poison cell, so one bad request takes down neither the
  process nor its neighbours;
- admission bounds the queue with an explicit ``rejected: backpressure``
  reply, per tenant too;
- every admitted request is spooled before it is queued
  (:class:`~blades_tpu_torch.service.spool.RequestSpool`) and its cells
  journaled, so a relaunch under ``BLADES_RESUME=1`` runs only what the
  killed process had not finished, and the reply is the same;
- SIGTERM drains: finish what was admitted, reply, exit 0;
- the server beats ``BLADES_HEARTBEAT_FILE`` at each cell and when idle,
  so ``python -m blades_tpu_torch.supervision`` supervises it;
- with ``workers=N`` (``serve start --workers N``) requests run in N
  worker processes on the server's device (:mod:`.worker`,
  :mod:`.workers`): the parent kills a worker whose cell outlives its
  deadline, and a dead worker's request (a crash, a kill, a dead CUDA
  context) resumes on a fresh one from its journal.

This ``__init__``, :mod:`.protocol`, :mod:`.client`, :mod:`.spool`,
:mod:`.scheduler`, :mod:`.handlers`, :mod:`.server`, :mod:`.worker` and
:mod:`.workers` import no torch at module scope: a client, and a server that serves only probe cells,
never load it. ``simulate`` cells and sweeps import it when they run, on
the server's ``device`` (``"cuda"`` by default, ``"cpu"`` on request).

Command line: ``python -m blades_tpu_torch.examples.serve
start|submit|status|result|metrics|drain``, one JSON line each.
"""

from __future__ import annotations

from blades_tpu_torch.service.client import ServiceClient, ServiceError  # noqa: F401
from blades_tpu_torch.service.protocol import (  # noqa: F401
    DEFAULT_SOCKET_NAME,
    mint_request_id,
    read_message,
    write_message,
)
from blades_tpu_torch.service.spool import RequestSpool  # noqa: F401

__all__ = [
    "DEFAULT_SOCKET_NAME",
    "RequestSpool",
    "ServiceClient",
    "ServiceError",
    "mint_request_id",
    "read_message",
    "write_message",
]
