"""Device memory gauges and guarded ``torch.profiler`` captures.

Counterpart: ``blades_tpu/telemetry/profiling.py`` — ``profile_dir_from_env``,
``memory_stats`` / ``record_live_bytes`` (the ``mem.*`` gauges) and
``start_capture`` / ``stop_capture``. The JAX module's
``record_program_profile`` (XLA's cost and memory analysis of a compiled
program) has no torch counterpart and is not here (``ROADMAP.md`` queue
A, slice 13b).

- :func:`record_live_bytes` — ``torch.cuda.memory_stats`` watermarks
  (``mem.bytes_in_use``, ``mem.peak_bytes_in_use``,
  ``mem.bytes_reserved``) as gauges that ride the next ``round``
  record. A CPU device reports no stats, and the gauges do not appear.
- :func:`start_capture` / :func:`stop_capture` — a ``torch.profiler``
  trace (CPU and, on the card, CUDA activity) of the run's ~3-round window
  (``profile_dir=`` or ``BLADES_PROFILE=<dir>``), exported as a Chrome
  trace into the directory. Each start and stop lands as a ``profile``
  record with ``ok`` or the reason it failed: a capture that fails is
  recorded, never a failed run.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from blades_tpu_torch.telemetry.recorder import Recorder, get_recorder

#: Env knob: directory for a profiler capture of the run's timed window.
PROFILE_ENV = "BLADES_PROFILE"

#: The file a capture exports into its directory.
TRACE_FILE = "trace.json"


def profile_dir_from_env() -> Optional[str]:
    """The capture directory (``BLADES_PROFILE``, with the older
    ``BLADES_TELEMETRY_PROFILE_DIR`` alias), or None."""
    return (os.environ.get(PROFILE_ENV) or os.environ.get("BLADES_TELEMETRY_PROFILE_DIR")
            or None)


def memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The CUDA allocator's counters for ``device`` (default the current
    card) as ``bytes_in_use`` / ``peak_bytes_in_use`` /
    ``bytes_reserved`` (the first two are the names ``jax.Device.
    memory_stats`` uses; the third is the caching allocator's reserve); None
    for a CPU device or without CUDA."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    try:
        stats = torch.cuda.memory_stats(device)
    except Exception:  # noqa: BLE001 - an allocator without stats
        return None
    out = {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_reserved": stats.get("reserved_bytes.all.current"),
    }
    return {k: int(v) for k, v in out.items() if v is not None} or None


def record_live_bytes(rec: Optional[Recorder] = None, device=None) -> None:
    """Gauge the device's live and peak bytes (``mem.*``) so they ride the
    next ``round`` record; a no-op where there are no allocator stats."""
    rec = rec or get_recorder()
    if not rec.enabled:
        return
    stats = memory_stats(device)
    for key, value in (stats or {}).items():
        rec.gauge(f"mem.{key}", value)


def start_capture(profile_dir: str, rec: Optional[Recorder] = None,
                  device=None) -> Optional[torch.profiler.profile]:
    """Start a ``torch.profiler`` capture (CPU, and CUDA for a CUDA
    ``device``) for ``profile_dir``; returns it, for :func:`stop_capture`,
    or None. A failure is a ``profile`` record with ``ok=False`` and the
    error, never an exception."""
    rec = rec or get_recorder()
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device is not None and torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 - observability must not fail the run
        rec.event("profile", action="start", dir=profile_dir, ok=False,
                  error=f"{type(e).__name__}: {e}"[:300])
        return None
    rec.event("profile", action="start", dir=profile_dir, ok=True)
    return prof


def stop_capture(profile_dir: str, prof: Optional[torch.profiler.profile],
                 rec: Optional[Recorder] = None) -> bool:
    """Stop the capture ``prof`` that :func:`start_capture` began (the
    device waited for first) and export its trace to
    ``<profile_dir>/trace.json``; same guarantees."""
    rec = rec or get_recorder()
    try:
        if prof is None:
            raise RuntimeError("no capture is running")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
    except Exception as e:  # noqa: BLE001
        rec.event("profile", action="stop", dir=profile_dir, ok=False,
                  error=f"{type(e).__name__}: {e}"[:300])
        return False
    rec.event("profile", action="stop", dir=profile_dir, ok=True)
    return True
