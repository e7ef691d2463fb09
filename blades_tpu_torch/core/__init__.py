"""Round engine (counterpart: ``blades_tpu/core/__init__.py``)."""

from blades_tpu_torch.core.engine import (
    ClientOptSpec,
    RoundEngine,
    RoundMetrics,
    RoundState,
    ServerOptSpec,
    multistep_lr,
    resolve_device,
)

__all__ = [
    "ClientOptSpec",
    "RoundEngine",
    "RoundMetrics",
    "RoundState",
    "ServerOptSpec",
    "multistep_lr",
    "resolve_device",
]
