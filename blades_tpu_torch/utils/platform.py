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

and nothing else. On the CPU they change nothing.

Nothing of the JAX module's XLA plumbing has a counterpart here:
``_xla_supports_flag``, ``virtual_cpu_flags``, ``virtual_cpu_env``,
``force_virtual_cpu`` and ``apply_env_platform`` build ``XLA_FLAGS`` and
``JAX_PLATFORMS`` for JAX's backends and its virtual CPU devices, which
torch has no notion of. The port chooses its device per call
(``device="cpu"``, the card by default; ``core/engine.py:resolve_device``).
"""

from __future__ import annotations

import torch


def apply_numerics() -> None:
    """Set the card's four numeric switches: cuDNN deterministic, cuDNN's
    benchmark search off, TF32 off for matmuls and for cuDNN."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def numerics() -> dict:
    """The four switches as they stand."""
    return {
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
