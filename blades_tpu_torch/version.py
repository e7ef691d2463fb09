"""Package version (counterpart: ``blades_tpu/version.py``)."""

__version__ = "0.1.0"
