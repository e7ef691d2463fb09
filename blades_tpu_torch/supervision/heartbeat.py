"""The per-round heartbeat file: the liveness signal of a supervised run.

Counterpart: ``blades_tpu/supervision/heartbeat.py`` (``beat`` :80,
``read``, ``age_s`` :152, the environment variables), copied. A hung run
(a stuck collective, a card that stopped answering) raises nothing; an
outside watcher can only see that it stopped making progress. A supervisor
exports :data:`HEARTBEAT_ENV`; the run calls :func:`beat` at every round
flush (``Simulator.run``) and at every sweep cell
(``telemetry/timeline.py:SweepAccounting``); the supervisor reads the
file's age with :func:`age_s`. Unset, :func:`beat` is a dict lookup and a
return.

The file holds one JSON ``heartbeat`` record, ``{"t": "heartbeat", "ts",
"pid", "round", "interval_s"}``: ``interval_s`` is the time since this
process's previous beat. With :data:`TIMEOUT_ENV` set, it also gauges the
margin to the supervisor's timeout and writes a ``heartbeat_margin``
record when a beat used more than :data:`MARGIN_WARN_FRAC` of it. Stdlib
only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

#: the heartbeat file's path, set by the supervisor; unset, beat is a no-op
HEARTBEAT_ENV = "BLADES_HEARTBEAT_FILE"

#: "1" under a supervisor: ``Simulator.run`` keeps (appends to) its trace
SUPERVISED_ENV = "BLADES_SUPERVISED"

#: "1" on a relaunch: ``Simulator.run`` resumes from its checkpoint or
#: crash autosave
RESUME_ENV = "BLADES_RESUME"

#: the supervisor's staleness timeout in seconds, for the margin gauge
TIMEOUT_ENV = "BLADES_HEARTBEAT_TIMEOUT"

#: a beat that used more than this share of the timeout is a warning
MARGIN_WARN_FRAC = 0.75

# wall clock of this process's previous beat (the margin only; the
# supervisor reads the file's mtime)
_last_beat_ts: Optional[float] = None


def heartbeat_path() -> Optional[str]:
    """This process's heartbeat file (None when unsupervised)."""
    return os.environ.get(HEARTBEAT_ENV) or None


def beat(round_idx: Optional[int] = None, path: Optional[str] = None) -> None:
    """Write the heartbeat file (one small write; its mtime is the signal).
    A no-op without ``path`` or :data:`HEARTBEAT_ENV`. Never raises: a full
    disk must not take down the run it watches."""
    global _last_beat_ts
    path = path or heartbeat_path()
    if not path:
        return
    now = time.time()
    rec = {"t": "heartbeat", "ts": now, "pid": os.getpid()}
    run_id = os.environ.get("BLADES_RUN_ID")
    if run_id:
        rec["run_id"] = run_id
        attempt = os.environ.get("BLADES_ATTEMPT")
        if attempt and attempt.isdigit():
            rec["attempt"] = int(attempt)
    if round_idx is not None:
        rec["round"] = int(round_idx)
    interval = None if _last_beat_ts is None else now - _last_beat_ts
    _last_beat_ts = now
    if interval is not None:
        rec["interval_s"] = round(interval, 3)
        try:
            from blades_tpu_torch.telemetry.recorder import get_recorder

            trec = get_recorder()
            trec.gauge("heartbeat.interval_s", round(interval, 3))
            timeout = float(os.environ.get(TIMEOUT_ENV) or 0) or None
            if timeout:
                trec.gauge("heartbeat.margin_s", round(timeout - interval, 3))
                if interval >= MARGIN_WARN_FRAC * timeout:
                    trec.event("heartbeat_margin", interval_s=round(interval, 3),
                               timeout_s=timeout, margin_s=round(timeout - interval, 3),
                               **({"round": int(round_idx)} if round_idx is not None else {}))
        except Exception:  # noqa: BLE001 - liveness must never raise
            pass
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def read(path: str) -> Optional[dict]:
    """The last heartbeat record written, or None (missing or torn file)."""
    try:
        with open(path) as fh:
            return json.loads(fh.read())
    except (OSError, ValueError):
        return None


def age_s(path: str, now: Optional[float] = None) -> Optional[float]:
    """Seconds since the heartbeat file was last written (None: no beat
    yet), from its mtime, not its body: a torn write still moves it."""
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    return (time.time() if now is None else now) - mtime
