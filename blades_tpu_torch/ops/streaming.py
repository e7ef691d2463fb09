"""Streaming (chunk-scanned) reductions over the client axis.

Counterpart: ``blades_tpu/ops/streaming.py`` — ``chunk_layout`` (:49),
the running moments ``moments_init`` / ``moments_update`` /
``moments_mean`` / ``moments_var`` (:68-107), the chunk stacks
``stack_init`` / ``stack_write`` / ``weighted_stack_mean`` (:109-133) and
``chunk_geometry`` (:136).

The streaming round (``core/engine.py`` with ``streaming=True``) feeds one
``[chunk, D]`` slab at a time into a small running state, so the ``[K, D]``
update matrix never exists. Masks follow ``ops/masked.py``: a masked-out row
enters a sum only through a 0 weight, and counts stay device tensors, so
nothing here waits for the device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def chunk_layout(num_rows: int, num_chunks: int) -> Tuple[int, int, int]:
    """``(num_chunks, chunk_size, pad)``: the chunk count clamps to the
    population, chunks are ceil-sized, and the count is renormalized
    against the ceil size, so no chunk is all padding (``pad <
    chunk_size``). The final chunk holds ``chunk_size - pad`` real rows."""
    c = max(1, min(int(num_chunks), int(num_rows)))
    chunk = -(-int(num_rows) // c)
    c = -(-int(num_rows) // chunk)
    return c, chunk, c * chunk - int(num_rows)


# -- running moments ------------------------------------------------------------


def moments_init(dim: int, dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    """Zero running-moment carry for a ``[*, dim]`` stream."""
    return {
        "sum": torch.zeros(dim, dtype=dtype, device=device),
        "sumsq": torch.zeros(dim, dtype=dtype, device=device),
        "count": torch.zeros((), dtype=dtype, device=device),
    }


def moments_update(m: Dict[str, Any], rows: torch.Tensor, mask: torch.Tensor) -> Dict[str, Any]:
    """Fold a ``[chunk, D]`` slab into the carry; masked-out rows add 0 (as
    ``x * 0``, so a non-finite masked-out row would show, as in JAX)."""
    w = mask.to(rows.dtype)[:, None]
    return {
        "sum": m["sum"] + (rows * w).sum(dim=0),
        "sumsq": m["sumsq"] + (rows * rows * w).sum(dim=0),
        "count": m["count"] + mask.to(m["count"].dtype).sum(),
    }


def moments_mean(m: Dict[str, Any]) -> torch.Tensor:
    """The stream's mean; the zero vector when it was empty."""
    return m["sum"] / torch.clamp_min(m["count"], 1.0)


def moments_var(m: Dict[str, Any]) -> torch.Tensor:
    """One-pass population variance ``E[x^2] - E[x]^2`` per coordinate,
    clamped at 0. It feeds the round's variance metrics only."""
    mu = moments_mean(m)
    return torch.clamp_min(m["sumsq"] / torch.clamp_min(m["count"], 1.0) - mu * mu, 0.0)


# -- chunk stacks -------------------------------------------------------------------


def stack_init(num_chunks: int, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Zero ``[num_chunks, *shape]`` accumulator of per-chunk summaries."""
    return torch.zeros((num_chunks,) + tuple(shape), dtype=dtype, device=device)


def stack_write(stack: torch.Tensor, chunk_index: int, value: torch.Tensor) -> torch.Tensor:
    """``stack`` with one chunk's summary written at ``chunk_index``. The
    engine's chunk loop is a host loop, so the index is a Python int and the
    write is in place."""
    stack[int(chunk_index)] = value.to(stack.dtype)
    return stack


def weighted_stack_mean(stack: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Count-weighted mean of chunk summaries, ``sum_j n_j a_j / sum_j n_j``;
    the zero vector when no chunk had a participant."""
    w = counts.to(stack.dtype)
    return (w @ stack) / torch.clamp_min(w.sum(), 1.0)


# -- chunk geometry -----------------------------------------------------------------


def chunk_geometry(slab: torch.Tensor, mask: torch.Tensor, center: torch.Tensor) -> Dict[str, Any]:
    """Per-chunk geometry against a chunk-local ``center``: ``row_dist``
    (each participating row's distance to it, 0 for masked-out rows),
    ``radius`` (their maximum) and ``diameter`` (the largest pairwise
    distance within the chunk, from the ``[chunk, chunk]`` Gram matrix)."""
    diff = slab - center[None, :]
    d = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=1), 0.0))
    d = torch.where(mask, d, 0.0)
    sq = (slab * slab).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (slab @ slab.T)
    pair = mask[:, None] & mask[None, :]
    diam = torch.sqrt(torch.clamp_min(torch.where(pair, d2, 0.0).max(), 0.0))
    return {"row_dist": d, "radius": d.max(), "diameter": diam}
