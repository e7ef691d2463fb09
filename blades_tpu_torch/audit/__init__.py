"""Defense certification and the runtime audit.

Counterpart: ``blades_tpu/audit/__init__.py`` (its exports, :22-70).
Three layers over the aggregator registry:

- :mod:`.contracts`: the contract battery (permutation invariance,
  translation equivariance, empirical (f, c)-resilience) each defense
  passes or opts out of with a reason (``Aggregator.audit_optouts``);
- :mod:`.attack_search`: the adaptive worst-case attack search per
  (defense, f), behind the certification matrix
  (``blades_tpu_torch/examples/certify.py``);
- :mod:`.monitor`: :class:`AuditMonitor`, the per-round certificates and
  the certified fallback inside the round.
"""

from blades_tpu_torch.audit.attack_search import (
    DEFAULT_GRIDS,
    QUICK_GRIDS,
    TEMPLATE_NAMES,
    search_cell,
    search_cell_staleness,
    search_cells,
    staleness_row_weights,
    synthetic_honest,
)
from blades_tpu_torch.audit.contracts import (
    CONTRACTS,
    DEFAULT_C,
    battery_ctx,
    battery_kwargs,
    battery_search_inputs,
    check_permutation,
    check_resilience,
    check_translation,
    nominal_f,
    resilience_from_cell,
    run_battery,
)
from blades_tpu_torch.audit.monitor import CERTIFICATE_NAMES, AuditMonitor

__all__ = [
    "AuditMonitor",
    "CERTIFICATE_NAMES",
    "CONTRACTS",
    "DEFAULT_C",
    "DEFAULT_GRIDS",
    "QUICK_GRIDS",
    "TEMPLATE_NAMES",
    "battery_ctx",
    "battery_kwargs",
    "battery_search_inputs",
    "resilience_from_cell",
    "check_permutation",
    "check_resilience",
    "check_translation",
    "nominal_f",
    "run_battery",
    "search_cell",
    "search_cell_staleness",
    "search_cells",
    "staleness_row_weights",
    "synthetic_honest",
]
