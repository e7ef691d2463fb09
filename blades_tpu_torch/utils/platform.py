"""The card's numeric settings, in one place.

Counterpart: ``blades_tpu/utils/platform.py``, the JAX package's one owner
of platform forcing, whose ``apply_env_platform()`` every JAX example calls
first. The port's drivers call :func:`apply_numerics` first instead: it sets
the four process-wide switches that decide which numbers a CUDA run gives,

- ``torch.backends.cudnn.deterministic`` (on: cuDNN's deterministic
  algorithms, so the same inputs give the same convolution results),
- ``torch.backends.cudnn.benchmark`` (off: no algorithm search by timing,
  which could pick a different algorithm from run to run),
- ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` (off: float32 matmuls and
  convolutions in float32, not TF32, as on the CPU and in the JAX package),

and nothing else. On the CPU they change nothing. :func:`set_numerics`
sets any of them by the names :func:`numerics` reports, and
:func:`numerics_scope` sets them for a ``with`` block and puts them back
after it: no other module of the port, ``chip_smoke.py`` included, writes
a switch (the lint ``XLA001``, ``analysis/rules/xla_flags.py``).

Nothing of the JAX module's XLA plumbing has a counterpart here:
``_xla_supports_flag``, ``virtual_cpu_flags``, ``virtual_cpu_env``,
``force_virtual_cpu`` and ``apply_env_platform`` build ``XLA_FLAGS`` and
``JAX_PLATFORMS`` for JAX's backends and its virtual CPU devices, which
torch has no notion of. The port chooses its device per call
(``device="cpu"``, the card by default; ``core/engine.py:resolve_device``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

#: each switch's name in :func:`numerics`, and its owner and attribute
_SWITCHES = {
    "cudnn_deterministic": (torch.backends.cudnn, "deterministic"),
    "cudnn_benchmark": (torch.backends.cudnn, "benchmark"),
    "matmul_allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
    "cudnn_allow_tf32": (torch.backends.cudnn, "allow_tf32"),
}


def apply_numerics() -> None:
    """Set the card's four numeric switches: cuDNN deterministic, cuDNN's
    benchmark search off, TF32 off for matmuls and for cuDNN."""
    set_numerics(cudnn_deterministic=True, cudnn_benchmark=False,
                 matmul_allow_tf32=False, cudnn_allow_tf32=False)


def numerics() -> dict:
    """The four switches as they stand."""
    return {name: getattr(owner, attr) for name, (owner, attr) in _SWITCHES.items()}


def set_numerics(**switches: bool) -> dict:
    """Set the named switches (the keys of :func:`numerics`); returns what
    they were before. An unknown name raises ``TypeError``."""
    unknown = sorted(set(switches) - set(_SWITCHES))
    if unknown:
        raise TypeError(f"unknown numeric switch(es) {unknown}; known: {sorted(_SWITCHES)}")
    before = {name: numerics()[name] for name in switches}
    for name, value in switches.items():
        owner, attr = _SWITCHES[name]
        setattr(owner, attr, bool(value))
    return before


@contextlib.contextmanager
def numerics_scope(**switches: bool) -> Iterator[None]:
    """Set the named switches for a ``with`` block; on leaving it, put
    back the switches named here as they were on entry."""
    before = set_numerics(**switches)
    try:
        yield
    finally:
        set_numerics(**before)
