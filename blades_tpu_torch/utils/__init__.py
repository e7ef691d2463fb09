"""Utilities (counterpart: ``blades_tpu/utils/__init__.py`` and its
package): random streams, run logging, metrics."""
