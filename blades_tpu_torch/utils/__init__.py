"""Utilities (counterpart: ``blades_tpu/utils/``): random streams, run
logging, metrics."""
