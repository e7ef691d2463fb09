"""Two-file run logging with reference parity.

Counterpart: ``blades_tpu/utils/logging.py:16-86``. A run writes a ``stats``
file (one Python-dict repr per line, typed by ``_meta.type``) and a free-text
``debug`` file. Initialization wipes the log dir, except the crash-recovery
artifacts a relaunch on the same ``log_path`` needs: ``*.npz`` checkpoint
archives, ``telemetry.jsonl`` and ``heartbeat``.
"""

from __future__ import annotations

import logging
import os
import shutil

_RUN_LOGGERS = ("stats", "debug")
_PRESERVE_SUFFIXES = (".npz",)
_PRESERVE_NAMES = ("telemetry.jsonl", "heartbeat")


def initialize_logger(log_root: str) -> None:
    """(Re)create ``log_root`` and attach fresh ``stats``/``debug`` loggers.

    Idempotent: re-initialization detaches and closes only these two
    loggers' handlers before attaching new ones. One bare ``%(message)s``
    per line.
    """
    # teardown first (handlers hold the files open), then wipe the dir
    for name in _RUN_LOGGERS:
        logger = logging.getLogger(name)
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        logger.setLevel(logging.INFO)
        # no propagation: a root handler would echo records in its own format
        logger.propagate = False
    if os.path.exists(log_root):
        for entry in os.listdir(log_root):
            if entry.endswith(_PRESERVE_SUFFIXES) or entry in _PRESERVE_NAMES:
                continue
            path = os.path.join(log_root, entry)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.unlink(path)
    os.makedirs(log_root, exist_ok=True)
    for name in _RUN_LOGGERS:
        fh = logging.FileHandler(os.path.join(log_root, name))
        fh.setLevel(logging.INFO)
        fh.setFormatter(logging.Formatter("%(message)s"))
        logging.getLogger(name).addHandler(fh)


def read_stats(log_root: str, type_filter: str | None = None) -> list:
    """Parse a ``stats`` file back into dicts."""
    out = []
    with open(os.path.join(log_root, "stats")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = eval(line, {"__builtins__": {}}, {"nan": float("nan"), "inf": float("inf")})
            if type_filter is None or rec.get("_meta", {}).get("type") == type_filter:
                out.append(rec)
    return out
