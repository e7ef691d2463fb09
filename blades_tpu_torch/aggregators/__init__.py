"""Robust-aggregator registry.

Counterpart: ``blades_tpu/aggregators/__init__.py:40-86`` (``AGGREGATORS``,
``get_aggregator``). Ported so far: ``mean`` and ``trimmedmean``. The other
names of the JAX registry raise and name the ``ROADMAP.md`` slice that
brings them.
"""

from __future__ import annotations

from typing import Callable, Dict, Type, Union

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.aggregators.mean import Mean
from blades_tpu_torch.aggregators.trimmedmean import Trimmedmean

AGGREGATORS: Dict[str, Type[Aggregator]] = {
    "mean": Mean,
    "trimmedmean": Trimmedmean,
}

#: names of the JAX registry still to port (ROADMAP.md queue A, slice 6)
UNPORTED = (
    "median", "krum", "multikrum", "geomed", "autogm", "centeredclipping",
    "clustering", "clippedclustering", "fltrust", "byzantinesgd", "dnc",
    "signguard", "asyncmean", "asynccenteredclipping",
)


def get_aggregator(name_or_fn: Union[str, Aggregator, Callable], **kwargs) -> Aggregator:
    """Resolve a name or pass through a custom aggregator callable/instance."""
    if isinstance(name_or_fn, Aggregator):
        return name_or_fn
    if callable(name_or_fn) and not isinstance(name_or_fn, str):
        return _wrap_callable(name_or_fn)
    if name_or_fn in UNPORTED:
        raise NotImplementedError(
            f"aggregator {name_or_fn!r} is not ported to blades_tpu_torch yet "
            "(ROADMAP.md queue A, slice 6)"
        )
    try:
        cls = AGGREGATORS[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown aggregator {name_or_fn!r}; available: {sorted(AGGREGATORS)}"
        ) from None
    return cls(**kwargs)


def _wrap_callable(fn: Callable) -> Aggregator:
    """Adapt a bare ``updates -> vector`` function."""

    class _Custom(Aggregator):
        def aggregate(self, updates, state=(), **ctx):
            return fn(updates), state

        def __repr__(self):
            return getattr(fn, "__name__", "custom")

    return _Custom()


__all__ = ["AGGREGATORS", "Aggregator", "Mean", "Trimmedmean", "get_aggregator"]
