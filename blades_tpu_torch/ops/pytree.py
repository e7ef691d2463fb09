"""Parameter dict <-> flat-vector utilities in the JAX package's flat order.

Counterpart: ``blades_tpu/ops/pytree.py:21-39`` (``ravel``,
``make_unraveler``, ``flat_dim`` over ``jax.flatten_util.ravel_pytree``).

The port keeps a model's parameters as a dict of tensors keyed by the torch
module's parameter names, in torch's layout (``nn.Linear.weight`` is
``[out, in]``, ``nn.Conv2d.weight`` is ``[out, in, kh, kw]``). The ``[K, D]``
update matrix, though, must be laid out coordinate for coordinate as the JAX
package lays it out, so that attacks and aggregators compare row for row.
``ravel_pytree`` walks the flax params dict with its keys sorted at every
level (``Dense_0/bias`` before ``Dense_0/kernel``) and flattens each leaf
row-major in flax's layout (a Dense kernel is ``[in, out]``, a Conv kernel
``[kh, kw, in, out]``, a 1-D Conv kernel ``[k, in, out]``). A
:class:`FlatLayout` records that walk once per model: the torch name of each
leaf in flat order, its torch shape, and the permutation that takes the flax
leaf to the torch one (:data:`DENSE`, :data:`CONV2D`, :data:`CONV1D`, or
``()`` where the two layouts agree, as for ``nn.Embed``'s ``[V, E]`` table).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import torch

Params = Dict[str, torch.Tensor]

#: torch ``[out, in]`` from flax's Dense kernel ``[in, out]``
DENSE = (1, 0)
#: torch OIHW ``[out, in, kh, kw]`` from flax's Conv kernel HWIO ``[kh, kw, in, out]``
CONV2D = (3, 2, 0, 1)
#: torch ``conv1d`` ``[out, in, k]`` from flax's 1-D Conv kernel ``[k, in, out]``
CONV1D = (2, 1, 0)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    name: str  # torch parameter name
    jax_path: Tuple[str, ...]  # path in the flax params dict
    shape: Tuple[int, ...]  # torch shape
    perm: Tuple[int, ...] = ()  # torch leaf = flax leaf permuted by perm; () = same layout

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def inverse(self) -> Tuple[int, ...]:
        """The permutation that takes the torch leaf back to flax's layout."""
        return tuple(sorted(range(len(self.perm)), key=self.perm.__getitem__))

    @property
    def flax_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[i] for i in self.inverse) if self.perm else self.shape


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """The leaves of a model in ``ravel_pytree`` order."""

    leaves: Tuple[LeafSpec, ...]

    @property
    def dim(self) -> int:
        return sum(leaf.size for leaf in self.leaves)


def make_layout(
    params: Mapping[str, torch.Tensor],
    jax_paths: Mapping[str, Tuple[Tuple[str, ...], Tuple[int, ...]]],
) -> FlatLayout:
    """Layout from a template params dict and the model's map
    ``torch name -> (flax path, perm)``. Sorting the flax paths as tuples of
    strings reproduces the sorted-keys walk of nested dicts."""
    if set(params) != set(jax_paths):
        raise ValueError(
            f"params {sorted(params)} and flax map {sorted(jax_paths)} differ"
        )
    leaves = []
    for name, (path, perm) in jax_paths.items():
        shape, perm = tuple(params[name].shape), tuple(perm)
        if perm and sorted(perm) != list(range(len(shape))):
            raise ValueError(f"{name}: {perm} is not a permutation of a {len(shape)}-d leaf")
        leaves.append(LeafSpec(name, tuple(path), shape, perm))
    return FlatLayout(tuple(sorted(leaves, key=lambda leaf: leaf.jax_path)))


def ravel(params: Mapping[str, torch.Tensor], layout: FlatLayout) -> torch.Tensor:
    """Flatten a params dict into one ``[D]`` vector in the JAX flat order."""
    return torch.cat(
        [
            (params[leaf.name].permute(leaf.inverse) if leaf.perm else params[leaf.name]).reshape(-1)
            for leaf in layout.leaves
        ]
    )


def make_unraveler(
    template: Mapping[str, torch.Tensor], layout: FlatLayout
) -> Tuple[int, Callable[[torch.Tensor], Params]]:
    """``(D, unravel)``: ``unravel`` maps a ``[D]`` vector back to a params
    dict in torch layout (permuted leaves come back as views)."""
    if flat_dim(template) != layout.dim:
        raise ValueError(f"template has {flat_dim(template)} scalars, layout {layout.dim}")

    def unravel(flat: torch.Tensor) -> Params:
        out, off = {}, 0
        for leaf in layout.leaves:
            seg = flat[off : off + leaf.size]
            off += leaf.size
            if leaf.perm:
                out[leaf.name] = seg.reshape(leaf.flax_shape).permute(leaf.perm)
            else:
                out[leaf.name] = seg.reshape(leaf.shape)
        return out

    return layout.dim, unravel


def flat_dim(params: Mapping[str, torch.Tensor]) -> int:
    """Number of scalar parameters."""
    return sum(int(t.numel()) for t in params.values())
