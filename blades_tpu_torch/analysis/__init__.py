"""Static invariant linter and round-program auditor of the port.

Counterpart: ``blades_tpu/analysis/__init__.py``. The rules that hold the
port up (no fallback that hides a kernel, the card's numeric switches set
in one place, the host-side modules importing no torch, one JSON line from
each driver, a round body free of host syncs) turned into a gate:

- **Tier A: AST lints** (stdlib ``ast``, no torch anywhere on this path):
  the rule engine (:mod:`blades_tpu_torch.analysis.core`) and the rules
  (:mod:`blades_tpu_torch.analysis.rules`), one per JAX rule ID. Each rule
  has an id, a severity and a rationale naming the incident behind it.
  Violations are suppressed per line with ``# blades: allow[RULE001]``,
  counted in the gate's JSON line.
- **Tier B: round-program audit**
  (:mod:`blades_tpu_torch.analysis.program_audit`): runs the port's real
  round, round-block, streaming, experiment-batch and buffered-async
  programs at a toy MLP configuration and checks that the state's buffers
  are reused where the engine promises it, that no op of a round makes a
  float64 tensor, and that a second same-shape call builds nothing.

Entry point (one JSON line, like the certify driver)::

    python -m blades_tpu_torch.analysis --check             # Tier A + Tier B
    python -m blades_tpu_torch.analysis --check --tier a    # lints only (no torch)

Import discipline: this module, :mod:`.core` and :mod:`.rules` are stdlib
only; only :mod:`.program_audit` imports torch.
"""

from blades_tpu_torch.analysis.core import (  # noqa: F401
    RepoIndex,
    Rule,
    Violation,
    run_rules,
)
from blades_tpu_torch.analysis.rules import all_rules  # noqa: F401

__all__ = ["RepoIndex", "Rule", "Violation", "run_rules", "all_rules"]
