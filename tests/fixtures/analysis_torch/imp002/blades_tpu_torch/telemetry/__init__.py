"""Fixture: IMP002. Reference counterpart: none — lint fixture."""
from blades_tpu_torch.telemetry import metric_pack  # VIOLATION: submodule-only
