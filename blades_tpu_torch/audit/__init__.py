"""Defense audit: the runtime per-round certificates and certified
fallback (:class:`AuditMonitor`).

Counterpart: ``blades_tpu/audit/__init__.py``. Of the JAX package's three
layers the port has the runtime monitor (``monitor.py``); the offline
contract battery (``contracts.py``) and the worst-case attack search
(``attack_search.py``) are ``ROADMAP.md`` queue A, slice 10b.
"""

from blades_tpu_torch.audit.monitor import CERTIFICATE_NAMES, AuditMonitor

__all__ = ["AuditMonitor", "CERTIFICATE_NAMES"]
