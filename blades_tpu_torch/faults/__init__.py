"""System-fault injection for federated rounds (counterpart:
``blades_tpu/faults/__init__.py``): client dropout, stragglers replaying
stale updates, NaN/Inf/bit-flip payload corruption and the server-side
non-finite guard, all as masks and ``where`` over the ``[K, D]`` update
matrix; the mask-aware aggregation path (``Aggregator.aggregate_masked``)
then aggregates over the clients that delivered."""

from blades_tpu_torch.faults.model import FaultModel, draw_faults

__all__ = ["FaultModel", "draw_faults"]
