"""Fixture: SCHEMA001. Reference counterpart: none — lint fixture."""
from blades_tpu_torch.telemetry import get_recorder


def log_surprise():
    get_recorder().event("fixture_undeclared_type", x=1)  # VIOLATION
