"""The sweep journal: one line per finished cell, so a killed sweep resumes
where it stopped.

Counterpart: ``blades_tpu/sweeps/journal.py`` (``SweepJournal`` :74,
``KILL_AT_ENV``, ``_locked_write`` :258, ``_load_lines`` :284), copied
with its line format, header and fingerprint guard: a journal written by
either package loads in the other.

The sweep's ``sweep`` records say which cells finished; the journal keeps
their results. Each finished cell is one JSON line ``{"kind": "cell",
"cell", "ts", "wall_s", "result"}``, written at the cell boundary; a
relaunch under ``BLADES_RESUME=1`` recovers every journaled cell and runs
only the rest. Entries are keyed by label, last write wins.

The first line, ``{"kind": "meta", "fp", "ts", "pid"}``, holds a
fingerprint of the sweep's configuration: a resume whose fingerprint
differs starts fresh, since merging two configurations' results would
give a matrix no run produced. A quarantined cell (``sweeps/resilient.py``)
is journaled too, as ``{"kind": "quarantine", "cell", "error",
"error_type", ...}``, and a resume does not run it again: the failure that
stopped it once would stop it again. A fresh (non-resume) launch clears
the journal, and with it the quarantines.

Each line is one ``os.write`` to an ``O_APPEND`` descriptor under a
best-effort ``flock``, so two processes appending at once (a killed
attempt's last write and its relaunch's first) never interleave within a
line, and a line killed mid-write is the one torn tail the loader skips.
The module itself uses the standard library only.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["SweepJournal", "KILL_AT_ENV"]

#: For tests only: set to an integer N, the journal SIGKILLs its own
#: process right after its N-th line is written, once (a
#: ``<journal>.kill_fired`` sentinel disarms it), so a sweep dies at a
#: known cell boundary with its result on disk and no clean-up run
KILL_AT_ENV = "BLADES_SWEEP_KILL_AT"


class SweepJournal:
    """Append-only per-cell result journal with a fingerprint-guarded resume.

    ::

        journal = SweepJournal(path, fingerprint=fp, resume=resumed)
        done = journal.results()          # label -> result (maybe empty)
        ... run only the cells not in ``done`` ...
        journal.record(label, result, wall_s=w)   # at each cell boundary

    ``resume=False`` truncates any journal at ``path`` and clears the kill
    sentinel. ``resume=True`` loads its entries, unless its fingerprint
    differs from ``fingerprint``: then it starts fresh and :attr:`resumed`
    stays False.
    """

    def __init__(self, path: str, fingerprint: Optional[str] = None, resume: bool = False):
        self.path = path
        self.fingerprint = fingerprint
        self.resumed = False
        self._entries: Dict[str, Dict[str, Any]] = {}
        self._quarantined: Dict[str, Dict[str, Any]] = {}
        self._fd: Optional[int] = None
        if resume and os.path.exists(path):
            loaded = _load_lines(path)
            meta = next((r for r in loaded if r.get("kind") == "meta"), None)
            if meta is not None and (fingerprint is None or meta.get("fp") == fingerprint):
                for r in loaded:
                    if r.get("kind") == "cell" and "cell" in r:
                        self._entries[r["cell"]] = r
                    elif r.get("kind") == "quarantine" and "cell" in r:
                        self._quarantined[r["cell"]] = r
                self.resumed = True
        if not self.resumed:
            self._reset()
        self._open()
        if not self.resumed:
            self._append({"kind": "meta", "fp": fingerprint, "ts": time.time(),
                          "pid": os.getpid()})

    # -- state ---------------------------------------------------------------

    def results(self) -> Dict[str, Any]:
        """label -> recovered result (finished cells only)."""
        return {k: v["result"] for k, v in self._entries.items()}

    def entry(self, label: str) -> Optional[Dict[str, Any]]:
        """A finished cell's whole entry (result and wall), or None."""
        return self._entries.get(label)

    def quarantined(self) -> Dict[str, Dict[str, Any]]:
        """label -> quarantine entry (error, error_type, batch)."""
        return dict(self._quarantined)

    def has(self, label: str) -> bool:
        """True when a resume need not run ``label``: its result was
        recovered, or it was quarantined."""
        return label in self._entries or label in self._quarantined

    def recovered(self, labels: Iterable[str]) -> List[str]:
        """The labels the journal holds, in input order."""
        return [lab for lab in labels if self.has(lab)]

    def __len__(self) -> int:
        return len(self._entries) + len(self._quarantined)

    # -- recording -----------------------------------------------------------

    def record(self, label: str, result: Any, wall_s: float = 0.0, **extra) -> None:
        """Journal one finished cell, on disk before this returns."""
        entry = {"kind": "cell", "cell": str(label), "ts": time.time(),
                 "wall_s": round(float(wall_s), 6), "result": result, **extra}
        self._entries[str(label)] = entry
        self._append(entry)
        self._maybe_kill()

    def record_quarantine(self, label: str, error: str, error_type: str,
                          batch: Optional[str] = None, attempts: Optional[int] = None) -> None:
        """Journal one quarantined cell with its error."""
        entry = {"kind": "quarantine", "cell": str(label), "ts": time.time(),
                 "error": str(error)[:500], "error_type": str(error_type)}
        if batch is not None:
            entry["batch"] = batch
        if attempts is not None:
            entry["attempts"] = int(attempts)
        self._quarantined[str(label)] = entry
        self._append(entry)
        self._maybe_kill()

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    # -- internals -----------------------------------------------------------

    @property
    def _sentinel(self) -> str:
        return self.path + ".kill_fired"

    def _reset(self) -> None:
        for p in (self.path, self._sentinel):
            try:
                os.unlink(p)
            except OSError:
                pass

    def _open(self) -> None:
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        # O_APPEND: the kernel keeps every writer's offset at the end
        self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    def _append(self, entry: Dict[str, Any]) -> None:
        if self._fd is None:
            self._open()
        # one write(2) a line, past the interpreter's buffer: in the page
        # cache (and so past a SIGKILL) when this returns
        _locked_write(self._fd, (json.dumps(entry, default=_json_default) + "\n").encode())

    def _maybe_kill(self) -> None:
        """The test saboteur (:data:`KILL_AT_ENV`)."""
        kill_at = os.environ.get(KILL_AT_ENV)
        if not kill_at:
            return
        try:
            if len(self) != int(kill_at):
                return
        except ValueError:
            return
        if os.path.exists(self._sentinel):
            return
        open(self._sentinel, "w").close()
        os.kill(os.getpid(), signal.SIGKILL)  # no autosave, no clean-up


def _locked_write(fd: int, data: bytes) -> None:
    """One whole-line append under a best-effort advisory lock; a lock that
    fails (no lock daemon, EINTR) leaves the single unlocked write."""
    import fcntl

    locked = False
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        locked = True
    except OSError:
        pass
    try:
        os.write(fd, data)
    finally:
        if locked:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass


def _load_lines(path: str) -> List[Dict[str, Any]]:
    """The journal's records, blank and torn lines skipped (a writer killed
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


def _json_default(obj):
    """numpy and torch scalars in a result, without importing either."""
    for attr in ("item", "tolist"):
        if hasattr(obj, attr):
            try:
                return getattr(obj, attr)()
            except Exception:  # noqa: BLE001 - fall through to repr
                pass
    return repr(obj)
