"""A run's ``memory`` record, device memory gauges and guarded
``torch.profiler`` captures.

Counterpart: ``blades_tpu/telemetry/profiling.py`` — ``profile_dir_from_env``,
``record_program_profile`` (:106-143), ``memory_stats`` /
``record_live_bytes`` (the ``mem.*`` gauges) and ``start_capture`` /
``stop_capture``.

- :func:`record_program_profile` — one ``memory`` record per run, for
  ``round`` (the first eager round) or ``block`` (the first round block),
  as ``Simulator.run`` calls it (JAX ``simulator.py:903-915``,
  ``:1134-1142``), with the schema's allocator fields only:
  ``argument_bytes`` (the state and inputs the program takes),
  ``output_bytes`` (the state and outputs it returns) and, for a block run
  as a CUDA graph, ``temp_bytes``: what the allocator reserved for the
  graph's private pool during the capture (``core/graphs.py``). An eager
  round has no ``temp_bytes``: its scratch shows only in the process's
  peak, which only ``torch.cuda.reset_peak_memory_stats`` could isolate,
  and a round must not reset a peak its caller reads. XLA's cost-model
  fields (``flops``, ``bytes_accessed``, ``optimal_seconds``,
  ``generated_code_bytes``, ``alias_bytes``) have no counterpart here and
  never appear. A CPU run emits no record, as it has no ``mem.*`` gauges.

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

def tensor_bytes(tree) -> int:
    """The bytes of the tensors in a pytree (their metadata only: no sync)."""
    from torch.utils._pytree import tree_flatten

    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


def record_program_profile(name: str, device, *, argument_bytes: int, output_bytes: int,
                           temp_bytes: Optional[int] = None,
                           rec: Optional[Recorder] = None) -> Optional[Dict[str, int]]:
    """Emit one ``memory`` record for the program ``name`` (``"round"`` or
    ``"block"``) on a CUDA ``device``; returns its fields, or None where
    nothing is emitted (a CPU device, telemetry off). The JAX package's
    ``BLADES_PROGRAM_PROFILE`` switch guards a re-lowering this record does
    not need, and is not here."""
    rec = rec or get_recorder()
    if not rec.enabled or torch.device(device).type != "cuda":
        return None
    fields = {"argument_bytes": int(argument_bytes), "output_bytes": int(output_bytes)}
    if temp_bytes is not None:
        fields["temp_bytes"] = int(temp_bytes)
    rec.event("memory", program=name, **fields)
    return fields


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
