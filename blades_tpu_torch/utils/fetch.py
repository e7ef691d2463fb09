"""Offline-gated download plumbing.

Counterpart: ``blades_tpu/utils/fetch.py`` (``offline`` :24, ``fetch_to``
:28-52), copied so that the port imports nothing of the JAX package. One
implementation of the fetch contract, used by the pretrained-weight registry
(``models/pretrained.py``): honor ``BLADES_TPU_OFFLINE=1`` with an actionable
error, stream to a ``.part`` temp file, atomically rename on success, clean up
and wrap any failure into one RuntimeError naming the manual-placement path.
"""

from __future__ import annotations

import os
import shutil
from typing import IO, Callable

_CHUNK = 32768


def offline() -> bool:
    return os.environ.get("BLADES_TPU_OFFLINE") == "1"


def fetch_to(destination: str, open_stream: Callable[[], IO[bytes]], what: str) -> str:
    """Stream ``open_stream()`` into ``destination`` (atomic, gated).

    ``what`` names the resource in error messages (e.g. a URL)."""
    if offline():
        raise RuntimeError(
            f"downloads disabled (BLADES_TPU_OFFLINE=1); fetch {what} on a "
            f"connected machine and place it at {destination}."
        )
    os.makedirs(os.path.dirname(destination) or ".", exist_ok=True)
    tmp = destination + ".part"
    try:
        with open_stream() as resp, open(tmp, "wb") as f:
            shutil.copyfileobj(resp, f, _CHUNK)
        os.replace(tmp, destination)
    except Exception as e:  # noqa: BLE001 - one actionable error per failure
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"could not download {what} ({type(e).__name__}: {e}); in "
            f"offline environments place the file at {destination} manually."
        ) from e
    return destination
