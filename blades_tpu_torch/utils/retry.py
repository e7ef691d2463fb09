"""Bounded exponential backoff, and a retry loop for flaky host-side calls.

Counterpart: ``blades_tpu/utils/retry.py`` (``backoff_delay`` :26,
``retry_call`` :39), copied. :func:`backoff_delay` is the one backoff
curve of the port: the resilient sweep executors
(``sweeps/resilient.py``) retry a failed cell on it, and the run
supervisor (``supervision/supervisor.py``) spaces its relaunches on it.
:func:`retry_call` turns a transient failure into a recorded retry: each
retry counts ``retry.<describe>`` and writes a ``retry`` record on the
active recorder (``telemetry/recorder.py``). Stdlib only.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from blades_tpu_torch.telemetry.recorder import get_recorder

T = TypeVar("T")


def backoff_delay(attempt: int, base_delay: float = 1.0, max_delay: float = 60.0) -> float:
    """The delay before retry ``attempt`` (1-based):
    ``min(base_delay * 2**(attempt-1), max_delay)``."""
    return min(base_delay * 2.0 ** (attempt - 1), max_delay)


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 1.0,
    max_delay: float = 60.0,
    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
    describe: str = "operation",
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping :func:`backoff_delay`
    between tries. An exception outside ``retry_on``, and the last attempt's
    failure, propagate unchanged. ``on_retry(attempt, delay, exc)`` runs
    before each sleep."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == attempts:
                raise
            delay = backoff_delay(attempt, base_delay, max_delay)
            rec = get_recorder()
            rec.counter(f"retry.{describe}")
            rec.event("retry", what=describe, attempt=attempt, delay_s=delay,
                      error=f"{type(e).__name__}: {e}"[:300])
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
