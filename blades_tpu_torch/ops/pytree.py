"""Parameter dict <-> flat-vector utilities in the JAX package's flat order.

Counterpart: ``blades_tpu/ops/pytree.py:21-39`` (``ravel``,
``make_unraveler``, ``flat_dim`` over ``jax.flatten_util.ravel_pytree``).

The port keeps a model's parameters as a dict of tensors keyed by the torch
module's parameter names, in torch's layout (``nn.Linear.weight`` is
``[out, in]``). The ``[K, D]`` update matrix, though, must be laid out
coordinate for coordinate as the JAX package lays it out, so that attacks and
aggregators compare row for row. ``ravel_pytree`` walks the flax params dict
with its keys sorted at every level (``Dense_0/bias`` before
``Dense_0/kernel``) and flattens each leaf row-major in flax's layout (a
Dense kernel is ``[in, out]``). A :class:`FlatLayout` records that walk once
per model: the torch name of each leaf in flat order, its torch shape, and
whether it is stored transposed relative to flax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    name: str  # torch parameter name
    jax_path: Tuple[str, ...]  # path in the flax params dict
    shape: Tuple[int, ...]  # torch shape
    transposed: bool  # torch stores the flax leaf transposed ([out, in])

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The leaves of a model in ``ravel_pytree`` order."""

    leaves: Tuple[LeafSpec, ...]

    @property
    def dim(self) -> int:
        return sum(leaf.size for leaf in self.leaves)


def make_layout(
    params: Mapping[str, torch.Tensor],
    jax_paths: Mapping[str, Tuple[Tuple[str, ...], bool]],
) -> FlatLayout:
    """Layout from a template params dict and the model's map
    ``torch name -> (flax path, transposed)``. Sorting the flax paths as
    tuples of strings reproduces the sorted-keys walk of nested dicts."""
    if set(params) != set(jax_paths):
        raise ValueError(
            f"params {sorted(params)} and flax map {sorted(jax_paths)} differ"
        )
    leaves = [
        LeafSpec(name, tuple(path), tuple(params[name].shape), bool(tr))
        for name, (path, tr) in jax_paths.items()
    ]
    return FlatLayout(tuple(sorted(leaves, key=lambda leaf: leaf.jax_path)))


def ravel(params: Mapping[str, torch.Tensor], layout: FlatLayout) -> torch.Tensor:
    """Flatten a params dict into one ``[D]`` vector in the JAX flat order."""
    return torch.cat(
        [
            (params[leaf.name].t() if leaf.transposed else params[leaf.name]).reshape(-1)
            for leaf in layout.leaves
        ]
    )


def make_unraveler(
    template: Mapping[str, torch.Tensor], layout: FlatLayout
) -> Tuple[int, Callable[[torch.Tensor], Params]]:
    """``(D, unravel)``: ``unravel`` maps a ``[D]`` vector back to a params
    dict in torch layout (transposed leaves come back as views)."""
    if flat_dim(template) != layout.dim:
        raise ValueError(f"template has {flat_dim(template)} scalars, layout {layout.dim}")

    def unravel(flat: torch.Tensor) -> Params:
        out, off = {}, 0
        for leaf in layout.leaves:
            seg = flat[off : off + leaf.size]
            off += leaf.size
            if leaf.transposed:
                out[leaf.name] = seg.reshape(leaf.shape[::-1]).t()
            else:
                out[leaf.name] = seg.reshape(leaf.shape)
        return out

    return layout.dim, unravel


def flat_dim(params: Mapping[str, torch.Tensor]) -> int:
    """Number of scalar parameters."""
    return sum(int(t.numel()) for t in params.values())
