"""Run supervision: the per-round heartbeat a supervised run writes.

Counterpart: ``blades_tpu/supervision/__init__.py``. The port has the
workload's half, :mod:`.heartbeat` (the liveness file and the
supervisor's environment variables); the supervisor process itself
(``blades_tpu/supervision/supervisor.py``: process groups, the watchdog,
relaunch with resume) is ``ROADMAP.md`` queue A, slice 13. Stdlib only.
"""

from blades_tpu_torch.supervision.heartbeat import (  # noqa: F401
    HEARTBEAT_ENV,
    RESUME_ENV,
    SUPERVISED_ENV,
    TIMEOUT_ENV,
    age_s,
    beat,
    heartbeat_path,
)

__all__ = ["HEARTBEAT_ENV", "RESUME_ENV", "SUPERVISED_ENV", "TIMEOUT_ENV", "age_s", "beat",
           "heartbeat_path"]
