"""Round engine (counterpart: ``blades_tpu/core/__init__.py``)."""

from blades_tpu_torch.core.engine import (
    ClientOptSpec,
    RoundEngine,
    RoundInputs,
    RoundMetrics,
    RoundSpec,
    RoundState,
    ServerOptSpec,
    multistep_lr,
    resolve_device,
)
from blades_tpu_torch.core.experiments import (
    ExperimentBatch,
    stack_experiments,
    unstack_experiments,
)

__all__ = [
    "ClientOptSpec",
    "ExperimentBatch",
    "RoundEngine",
    "RoundInputs",
    "RoundMetrics",
    "RoundSpec",
    "RoundState",
    "ServerOptSpec",
    "multistep_lr",
    "resolve_device",
    "stack_experiments",
    "unstack_experiments",
]
