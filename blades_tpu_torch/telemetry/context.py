"""Trace context: the run identity stamped on every telemetry record.

Counterpart: ``blades_tpu/telemetry/context.py`` (copied: the port imports
nothing of the JAX package). Two environment-propagated fields identify
one logical run across a process tree:

- ``run_id`` — minted once at the top of an entry point
  (``Simulator.run``) and exported as :data:`RUN_ID_ENV`, so every child
  process inherits it;
- ``attempt`` — 1 by default; a supervisor re-exports :data:`ATTEMPT_ENV`
  per relaunch, so all attempts of one supervised run share a ``run_id``.

The :class:`~blades_tpu_torch.telemetry.recorder.Recorder` stamps both onto
the ``meta`` record and every later record's envelope.

An id found in the environment that THIS process minted (kept in
:data:`_minted`) is minted anew on ``activate(fresh=True)``: two
sequential top-level runs in one process are two experiments. An id
inherited from a parent process is never minted anew.

Stdlib only.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Optional

#: Env var carrying the run id across the process tree.
RUN_ID_ENV = "BLADES_RUN_ID"

#: Env var carrying the (supervisor-incremented) attempt number.
ATTEMPT_ENV = "BLADES_ATTEMPT"

# run ids THIS process minted: an env id in here is ours (mintable anew on
# a fresh top-level run); an env id not in here was inherited from a parent
_minted: set = set()


@dataclasses.dataclass(frozen=True)
class RunContext:
    """The (run_id, attempt) pair identifying one logical run."""

    run_id: str
    attempt: int
    inherited: bool = False

    def env(self) -> dict:
        """The env-var dict that propagates this context to children."""
        return {RUN_ID_ENV: self.run_id, ATTEMPT_ENV: str(self.attempt)}


def mint_run_id() -> str:
    """A fresh, human-sortable run id: UTC timestamp + random suffix."""
    return time.strftime("%Y%m%dT%H%M%S", time.gmtime()) + "-" + uuid.uuid4().hex[:6]


def _attempt_from_env() -> int:
    raw = os.environ.get(ATTEMPT_ENV)
    try:
        return max(1, int(raw)) if raw else 1
    except ValueError:
        return 1


def current() -> Optional[RunContext]:
    """The active context from the environment, or None when unset."""
    run_id = os.environ.get(RUN_ID_ENV)
    if not run_id:
        return None
    return RunContext(run_id=run_id, attempt=_attempt_from_env(),
                      inherited=run_id not in _minted)


def activate(fresh: bool = False) -> RunContext:
    """Return the process run context, minting and exporting it when needed.

    ``fresh=True`` (entry points call this): mint anew when the existing
    env id was minted by THIS process. An inherited id is never minted
    anew; the attempt number then comes from :data:`ATTEMPT_ENV`.
    """
    ctx = current()
    if ctx is not None and (ctx.inherited or not fresh):
        return ctx
    run_id = mint_run_id()
    _minted.add(run_id)
    os.environ[RUN_ID_ENV] = run_id
    os.environ[ATTEMPT_ENV] = "1"
    return RunContext(run_id=run_id, attempt=1, inherited=False)


def envelope() -> dict:
    """The ``{"run_id": ..., "attempt": ...}`` fields the recorder stamps
    onto every record (empty when no context is active)."""
    ctx = current()
    if ctx is None:
        return {}
    return {"run_id": ctx.run_id, "attempt": ctx.attempt}

