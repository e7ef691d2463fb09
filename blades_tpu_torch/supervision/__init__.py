"""Run supervision: the per-round heartbeat a supervised run writes, and the
supervisor that watches it.

Counterpart: ``blades_tpu/supervision/__init__.py``. Two modules:

- :mod:`.heartbeat`: the liveness file a supervised workload beats at each
  round flush and sweep cell, and the supervisor's environment variables;
- :mod:`.supervisor`: :class:`Supervisor` / :func:`supervise` launch a
  workload in a process group of its own, kill the whole group when its
  heartbeat goes stale or its deadline passes (SIGTERM, SIGCONT, SIGKILL),
  and relaunch it under ``BLADES_RESUME=1`` with a bounded backoff.

The heartbeat is imported at once (a workload's first beat must not wait
for more); the supervisor's names resolve on first use.

CLI: ``python -m blades_tpu_torch.supervision [opts] -- python -m ...``.
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

_LAZY = {
    name: ("blades_tpu_torch.supervision.supervisor", name)
    for name in ("POLICIES", "AttemptRecord", "DegradePolicy", "SupervisedResult", "Supervisor",
                 "kill_process_group", "list_group", "resolve_policy", "supervise", "main")
}

__all__ = ["HEARTBEAT_ENV", "RESUME_ENV", "SUPERVISED_ENV", "TIMEOUT_ENV", "age_s", "beat",
           "heartbeat_path", *sorted(_LAZY)]


def __getattr__(name):  # PEP 562
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'blades_tpu_torch.supervision' has no attribute {name!r}")
