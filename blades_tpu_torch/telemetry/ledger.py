"""Run ledger: an append-only record of every run's provenance and outcome.

Counterpart: ``blades_tpu/telemetry/ledger.py`` (``LEDGER_ENV``,
``DEFAULT_PATH``, ``OUTCOMES``, ``run_started``, ``LedgerEntry.ended``,
``record_event``, ``read_ledger``, ``pair_runs``), copied. Every
``Simulator.run`` and every ``examples/certify.py`` sweep appends one
``started`` record when it starts and one ``finished`` / ``crashed`` /
``killed`` record when it ends, to the path in :data:`LEDGER_ENV`, else to
``results/ledger_torch.jsonl`` under the working directory
(``BLADES_LEDGER=0`` turns it off). The default is not the JAX package's
``results/ledger.jsonl``: a port run from the checkout's root never
appends to that committed file. A record carries the run identity
(``telemetry/context.py``), a fingerprint of the run's configuration
(:func:`config_fingerprint`, the port's one copy, which ``sweeps``
re-exports, as ``blades_tpu/telemetry/ledger.py:61-64`` is the JAX
package's), the checked-out git
sha, an environment fingerprint (:func:`env_fingerprint`), and at the end
the outcome, headline metrics and artifact paths.

One ``os.write`` on an ``O_APPEND`` descriptor per record, two a run; a
ledger write never raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from blades_tpu_torch.telemetry import context as _context

#: the ledger's path; "0" turns ledger writes off
LEDGER_ENV = "BLADES_LEDGER"

#: the default path, relative to the working directory (the JAX package's
#: is ``results/ledger.jsonl``)
DEFAULT_PATH = os.path.join("results", "ledger_torch.jsonl")

#: the terminal outcomes a run can record
OUTCOMES = ("finished", "crashed", "killed")

__all__ = [
    "DEFAULT_PATH", "LEDGER_ENV", "LedgerEntry", "OUTCOMES", "code_version",
    "config_fingerprint", "env_fingerprint", "ledger_path", "pair_runs", "read_ledger",
    "record_event", "run_started",
]


def config_fingerprint(config: Dict[str, Any]) -> str:
    """Stable short hash of a canonical (JSON-serializable) config dict."""
    blob = json.dumps(config, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def ledger_path() -> Optional[str]:
    """The ledger's path, or None when it is off."""
    raw = os.environ.get(LEDGER_ENV)
    if raw == "0":
        return None
    return raw or DEFAULT_PATH


def code_version() -> Optional[str]:
    """The checked-out git sha, read from ``.git`` (no subprocess); None
    outside a git checkout."""
    git = ".git"
    if not os.path.exists(git):
        here = os.path.dirname(os.path.abspath(__file__))
        while here != os.path.dirname(here):
            cand = os.path.join(here, ".git")
            if os.path.exists(cand):
                git = cand
                break
            here = os.path.dirname(here)
    try:
        if os.path.isfile(git):
            # a worktree: .git is a "gitdir: <path>" pointer
            with open(git) as fh:
                pointer = fh.read().strip()
            if not pointer.startswith("gitdir:"):
                return None
            git = os.path.join(os.path.dirname(os.path.abspath(git)),
                               pointer.split(":", 1)[1].strip())
        with open(os.path.join(git, "HEAD")) as fh:
            head = fh.read().strip()
        if not head.startswith("ref:"):
            return head[:40] or None
        ref = head.split(None, 1)[1]
        common = git
        commondir = os.path.join(git, "commondir")
        if os.path.isfile(commondir):
            with open(commondir) as fh:
                common = os.path.join(git, fh.read().strip())
        for root in (git, common):
            ref_path = os.path.join(root, *ref.split("/"))
            if os.path.exists(ref_path):
                with open(ref_path) as fh:
                    return fh.read().strip()[:40] or None
        with open(os.path.join(common, "packed-refs")) as fh:
            for line in fh:
                if line.strip().endswith(ref):
                    return line.split(None, 1)[0][:40]
    except OSError:
        pass
    return None


def env_fingerprint() -> Dict[str, Any]:
    """Python, torch and its CUDA runtime, the platform, and the card's name
    and count, the last two only when torch has CUDA up already: this never
    initializes CUDA."""
    import platform as _platform

    fp: Dict[str, Any] = {"python": _platform.python_version(), "platform": sys.platform}
    torch = sys.modules.get("torch")
    if torch is not None:
        fp["torch"] = torch.__version__
        fp["cuda_runtime"] = torch.version.cuda
        try:
            if torch.cuda.is_initialized():
                fp["device_kind"] = torch.cuda.get_device_name(0)
                fp["device_platform"] = "gpu"
                fp["n_devices"] = torch.cuda.device_count()
        except Exception:  # noqa: BLE001 - fingerprinting is best effort
            pass
    return fp


def _append(path: str, record: Dict[str, Any]) -> bool:
    """Append one whole JSONL line in one ``os.write`` on an ``O_APPEND``
    descriptor, so lines of concurrent writers cannot interleave; never
    raises."""
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        data = (json.dumps(record, default=repr) + "\n").encode()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        return True
    except (OSError, TypeError, ValueError):
        return False


class LedgerEntry:
    """One run's ledger handle: ``started`` at :func:`run_started`, exactly
    one terminal record through :meth:`ended` (the first outcome wins)."""

    def __init__(self, path: Optional[str], record: Dict[str, Any]):
        self.path = path
        self.record = record
        self.t0 = time.time()
        self._closed = False

    def ended(self, outcome: str = "finished", metrics: Optional[Dict[str, Any]] = None,
              error: Optional[str] = None,
              artifacts: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
        if self._closed or self.path is None:
            return None
        self._closed = True
        rec: Dict[str, Any] = {
            "t": "ledger",
            "event": outcome if outcome in OUTCOMES else "finished",
            "ts": time.time(),
            "pid": os.getpid(),
            "run_id": self.record["run_id"],
            "attempt": self.record["attempt"],
            "kind": self.record["kind"],
            "wall_s": round(time.time() - self.t0, 3),
        }
        if metrics:
            rec["metrics"] = metrics
        if error:
            rec["error"] = str(error)[:500]
        if artifacts:
            rec["artifacts"] = list(artifacts)
        _append(self.path, rec)
        return rec


def run_started(kind: str, config: Optional[Dict[str, Any]] = None,
                artifacts: Optional[List[str]] = None, path: Optional[str] = None,
                **fields: Any) -> LedgerEntry:
    """Append this run's ``started`` record and return its handle; ``kind``
    names the entry point (``simulator``, ``certify``), ``config`` is the
    canonical configuration the fingerprint hashes (kept whole when
    small). With the ledger off the handle is inert."""
    target = path or ledger_path()
    ctx = _context.activate()
    rec: Dict[str, Any] = {
        "t": "ledger",
        "event": "started",
        "ts": time.time(),
        "pid": os.getpid(),
        "run_id": ctx.run_id,
        "attempt": ctx.attempt,
        "kind": kind,
        "env": env_fingerprint(),
    }
    sha = code_version()
    if sha:
        rec["code_version"] = sha
    if config is not None:
        rec["config_fingerprint"] = config_fingerprint(config)
        if len(json.dumps(config, default=repr)) <= 2000:
            rec["config"] = config
    if artifacts:
        rec["artifacts"] = list(artifacts)
    rec.update(fields)
    entry = LedgerEntry(target if target else None, rec)
    if target:
        _append(target, rec)
    return entry


def record_event(kind: str, event: str, run_id: Optional[str] = None,
                 attempt: Optional[int] = None, path: Optional[str] = None,
                 **fields: Any) -> Optional[Dict[str, Any]]:
    """Append a standalone ledger record (a watchdog's ``killed`` for a run
    that could not write its own); None when the ledger is off."""
    target = path or ledger_path()
    if not target:
        return None
    ctx = _context.current()
    rec: Dict[str, Any] = {
        "t": "ledger",
        "event": event if event in OUTCOMES or event == "started" else "killed",
        "ts": time.time(),
        "pid": os.getpid(),
        "run_id": run_id or (ctx.run_id if ctx else "unknown"),
        "attempt": attempt if attempt is not None else (ctx.attempt if ctx else 1),
        "kind": kind,
    }
    rec.update(fields)
    _append(target, rec)
    return rec


def read_ledger(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """A ledger file's records, skipping blank and torn lines; [] when it
    is missing or off."""
    target = path or ledger_path()
    out: List[Dict[str, Any]] = []
    if not target or not os.path.exists(target):
        return out
    try:
        with open(target) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


def pair_runs(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One summary per run attempt, joining ``started`` and terminal
    records by (run_id, attempt, kind) in record order (``outcome`` None
    while open). A terminal record with no open slot of its kind (a
    watchdog's ``killed``) closes the still-open slots of the same
    (run_id, attempt) instead of standing as a run of its own."""
    runs: Dict[tuple, List[Dict[str, Any]]] = {}

    def _new_slot(rec: Dict[str, Any]) -> Dict[str, Any]:
        return {"run_id": rec.get("run_id"), "attempt": rec.get("attempt"),
                "kind": rec.get("kind"), "outcome": None}

    orphans: List[Dict[str, Any]] = []
    for rec in records:
        if rec.get("t") != "ledger":
            continue
        key = (rec.get("run_id"), rec.get("attempt"), rec.get("kind"))
        slots = runs.setdefault(key, [])
        if rec.get("event") == "started":
            slot = _new_slot(rec)
            slots.append(slot)
            for field in ("ts", "config_fingerprint", "code_version", "config", "artifacts",
                          "env"):
                if field in rec:
                    slot[field] = rec[field]
            continue
        open_slots = [s for s in slots if s["outcome"] is None]
        if open_slots:
            slot = open_slots[-1]
        else:
            slot = _new_slot(rec)
            orphans.append(slot)
        slot["outcome"] = rec.get("event")
        for field in ("wall_s", "metrics", "error"):
            if field in rec:
                slot[field] = rec[field]
        if "artifacts" in rec and "artifacts" not in slot:
            slot["artifacts"] = rec["artifacts"]
    out: List[Dict[str, Any]] = []
    for slots in runs.values():
        out.extend(slots)
    for slot in orphans:
        siblings = [s for (rid, att, _kind), ss in runs.items() for s in ss
                    if (rid, att) == (slot["run_id"], slot["attempt"]) and s["outcome"] is None]
        for s in siblings:
            s["outcome"] = slot["outcome"]
            for field in ("metrics", "error"):
                if field in slot and field not in s:
                    s[field] = slot[field]
        if not siblings:
            out.append(slot)
    return out
