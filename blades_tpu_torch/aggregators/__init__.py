"""Robust-aggregator registry.

Counterpart: ``blades_tpu/aggregators/__init__.py:40-86`` (``AGGREGATORS``,
``get_aggregator``). Every defense of the reference's catalog and of
BASELINE.md is ported, with ByzantineSGD, SignGuard and the asynchronous
pair (``asyncmean``, ``asynccenteredclipping``), each in its dense and its
masked form: the whole JAX registry. So are the gossip aggregators of
``decentralized.py``, which the JAX registry does not list. A name in
:data:`UNPORTED` would raise and name the ``ROADMAP.md`` slice that brings
it; none is left.
"""

from __future__ import annotations

from typing import Callable, Dict, Type, Union

from blades_tpu_torch.aggregators.autogm import Autogm
from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.aggregators.byzantinesgd import Byzantinesgd
from blades_tpu_torch.aggregators.centeredclipping import Centeredclipping
from blades_tpu_torch.aggregators.clippedclustering import Clippedclustering
from blades_tpu_torch.aggregators.clustering import Clustering
from blades_tpu_torch.aggregators.decentralized import (
    AnchorClipping,
    Asynccenteredclipping,
    Asyncmean,
    DecentralizedMixing,
    fully_connected_adjacency,
    metropolis_weights,
    ring_adjacency,
    torus_adjacency,
)
from blades_tpu_torch.aggregators.dnc import Dnc
from blades_tpu_torch.aggregators.fltrust import Fltrust
from blades_tpu_torch.aggregators.geomed import Geomed
from blades_tpu_torch.aggregators.krum import Krum, Multikrum
from blades_tpu_torch.aggregators.mean import Mean
from blades_tpu_torch.aggregators.median import Median
from blades_tpu_torch.aggregators.signguard import Signguard
from blades_tpu_torch.aggregators.trimmedmean import Trimmedmean

AGGREGATORS: Dict[str, Type[Aggregator]] = {
    "mean": Mean,
    "median": Median,
    "trimmedmean": Trimmedmean,
    "krum": Krum,
    "multikrum": Multikrum,
    "geomed": Geomed,
    "autogm": Autogm,
    "centeredclipping": Centeredclipping,
    "clustering": Clustering,
    "clippedclustering": Clippedclustering,
    "fltrust": Fltrust,
    "byzantinesgd": Byzantinesgd,
    "dnc": Dnc,
    "signguard": Signguard,
    "asyncmean": Asyncmean,
    "asynccenteredclipping": Asynccenteredclipping,
}

#: names of the JAX registry still to port, each with its ROADMAP.md
#: queue-A slice (none)
UNPORTED: Dict[str, str] = {}


def get_aggregator(name_or_fn: Union[str, Aggregator, Callable], **kwargs) -> Aggregator:
    """Resolve a name or pass through a custom aggregator callable/instance."""
    if isinstance(name_or_fn, Aggregator):
        return name_or_fn
    if callable(name_or_fn) and not isinstance(name_or_fn, str):
        return _wrap_callable(name_or_fn)
    if name_or_fn in UNPORTED:
        raise NotImplementedError(
            f"aggregator {name_or_fn!r} is not ported to blades_tpu_torch yet "
            f"(ROADMAP.md queue A, {UNPORTED[name_or_fn]})"
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
        graph_unsafe_reason = "a bare callable, whose host syncs are unknown"

        def aggregate(self, updates, state=(), **ctx):
            return fn(updates), state

        def __repr__(self):
            return getattr(fn, "__name__", "custom")

    return _Custom()


__all__ = [
    "AGGREGATORS", "Aggregator", "AnchorClipping", "Asynccenteredclipping", "Asyncmean",
    "Autogm", "Byzantinesgd",
    "Centeredclipping", "Clippedclustering", "Clustering", "DecentralizedMixing", "Dnc",
    "Fltrust", "Geomed", "Krum", "Mean", "Median", "Multikrum", "Signguard", "Trimmedmean",
    "fully_connected_adjacency", "get_aggregator", "metropolis_weights", "ring_adjacency",
    "torus_adjacency",
]
