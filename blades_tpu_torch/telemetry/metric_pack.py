"""In-round metrics: a fixed-shape ``MetricPack`` per round.

Counterpart: ``blades_tpu/telemetry/metric_pack.py:61-246`` (``NBINS``,
``_EDGES``, ``MetricPack``, ``pack_init``, ``pack_update``,
``_masked_quantiles``, ``pack_finalize``, ``pack_dense``,
``pack_to_fields``). The pack is computed inside the round from the slabs
the aggregator consumes, so it survives round blocks (stacked ``[R]``) and
the streaming round (one fold per chunk), and the Simulator writes it as
one ``metrics`` record per round.

Contents per round:

- ``norm_q [5]`` — min / q25 / median / q75 / max of the participating
  rows' L2 update norms;
- ``norm_hist [NBINS]`` — counts of those norms in fixed log10-spaced bins
  (absolute edges, so histograms compare across rounds and runs);
- ``cos_honest`` / ``cos_byz`` — cosine between the mean honest (byzantine)
  participating update and the *applied* aggregate (0 for an empty group);
- ``n_participants`` / ``n_masked_out`` — rows that entered aggregation and
  rows excluded;
- ``slab_absmax [C]`` / ``slab_norm_max [C]`` — per client chunk, the
  largest ``|coordinate|`` and the largest row norm of the sanitized slab.

The dense round folds the same :func:`pack_update` over the streaming
round's chunk layout (``ops/streaming.chunk_layout``), chunk after chunk,
so the elementwise fields (norms, histogram, extremes, counts) of a dense
round, a block and a streaming round of the same rows are bit-identical
within the port. Against the JAX package the float fields agree to f32
rounding (XLA and torch sum in other orders), the integer fields exactly.

Every output is a device tensor and nothing waits for the device: the
histogram is a ``scatter_add_`` (``torch.bincount`` syncs on CUDA), the
quantile positions are tensor indices, and the bin edges are made on the
device (``torch.logspace`` in float64, rounded to float32: the float32
edges of the JAX package), so a captured round makes them too.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from blades_tpu_torch.ops.streaming import chunk_layout, stack_init, stack_write

#: Fixed histogram bin count; the first and last bins catch underflow and
#: overflow.
NBINS = 18

#: ``NBINS - 1`` interior edges 10^-8 ... 10^8, float64 as in the JAX
#: package, compared as float32 (JAX converts them when it traces).
_EDGES = np.logspace(-8.0, 8.0, NBINS - 1)


def edges(device) -> torch.Tensor:
    """:data:`_EDGES` as float32 on ``device``, made there (no host copy)."""
    return torch.logspace(-8.0, 8.0, NBINS - 1, dtype=torch.float64,
                          device=device).to(torch.float32)


class MetricPack(NamedTuple):
    """One round's metrics (module docstring); every field a device tensor."""

    norm_q: torch.Tensor  # [5] min/q25/median/q75/max of row update norms
    norm_hist: torch.Tensor  # [NBINS] int32 fixed-log-bin norm counts
    cos_honest: torch.Tensor  # 0-d: cos(mean honest update, applied agg)
    cos_byz: torch.Tensor  # 0-d: cos(mean byz update, applied agg)
    n_participants: torch.Tensor  # 0-d int32: rows that entered aggregation
    n_masked_out: torch.Tensor  # 0-d int32: K - participants
    slab_absmax: torch.Tensor  # [C] per-chunk max |coord| of the sanitized slab
    slab_norm_max: torch.Tensor  # [C] per-chunk max row norm


def pack_init(num_chunks: int, dim: int, device="cpu") -> Dict[str, Any]:
    """Zero fold state for one round's pack."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {
        "sum_honest": torch.zeros(dim, dtype=torch.float32, device=device),
        "sum_byz": torch.zeros(dim, dtype=torch.float32, device=device),
        "n_honest": zero,
        "n_byz": zero.clone(),
        "slab_absmax": stack_init(num_chunks, (), device=device),
        "slab_norm_max": stack_init(num_chunks, (), device=device),
    }


def pack_update(carry: Dict[str, Any], slab: torch.Tensor, mask: torch.Tensor,
                byz: torch.Tensor, chunk_index: int) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Fold one sanitized ``[chunk, D]`` slab into the round's pack state.

    ``slab`` has its masked-out rows zeroed (``Aggregator._sanitize``),
    ``mask`` covers the excluded rows and the final chunk's padding, ``byz``
    is the chunk's slice of the byzantine mask. Returns the new carry and
    the chunk's ``[chunk]`` row norms (0 for masked-out rows)."""
    m = mask.to(torch.float32)
    w_h = m * (~byz).to(torch.float32)
    w_b = m * byz.to(torch.float32)
    norms = torch.sqrt(torch.clamp_min((slab * slab).sum(dim=1), 0.0)) * m
    carry = {
        "sum_honest": carry["sum_honest"] + (slab * w_h[:, None]).sum(dim=0),
        "sum_byz": carry["sum_byz"] + (slab * w_b[:, None]).sum(dim=0),
        "n_honest": carry["n_honest"] + w_h.sum(),
        "n_byz": carry["n_byz"] + w_b.sum(),
        "slab_absmax": stack_write(carry["slab_absmax"], chunk_index, slab.abs().max()),
        "slab_norm_max": stack_write(carry["slab_norm_max"], chunk_index, norms.max()),
    }
    return carry, norms


def _norm(v: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum(v * v))``, as ``jnp.linalg.norm`` computes it: a summed
    reduction, where the CPU's float32 ``torch.linalg.vector_norm`` and
    ``torch.dot`` of a [D] vector at CCT-2's D are off by up to 1e-4
    relative (measured against float64), enough to move a cosine near 1."""
    return torch.sqrt((v * v).sum())


def _masked_quantiles(norms: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """min/q25/median/q75/max over the valid entries of ``norms [K]``: the
    positions ``floor(q * (n - 1))`` of an ascending sort with the invalid
    entries at ``+inf``; zeros for an empty round."""
    n = valid.to(torch.int32).sum(dtype=torch.int32)
    s = torch.sort(torch.where(valid, norms, torch.inf)).values
    nf = torch.clamp_min(n.to(torch.float32) - 1.0, 0.0)
    # 0, 0.25, 0.5, 0.75, 1 exactly, made on the device (no host copy)
    qs = torch.arange(5, dtype=torch.float32, device=norms.device) * 0.25
    idx = torch.floor(qs * nf).to(torch.int64).clamp(0, s.shape[0] - 1)
    q = s.index_select(0, idx)
    return torch.where(n > 0, q, torch.zeros_like(q))


def pack_finalize(carry: Dict[str, Any], norms: torch.Tensor, valid: torch.Tensor,
                  agg: torch.Tensor) -> MetricPack:
    """Close the fold into a :class:`MetricPack`. ``norms`` / ``valid``:
    the ``[K]`` row norms and participation mask; ``agg``: the aggregate
    the server APPLIED (after the audit's fallback)."""
    n = valid.to(torch.int32).sum(dtype=torch.int32)
    # side "left", as jnp.searchsorted's default; invalid rows land in bin 0
    # and add 0
    bins = torch.searchsorted(edges(norms.device), torch.where(valid, norms, -1.0))
    hist = torch.zeros(NBINS, dtype=torch.int32, device=norms.device)
    hist.scatter_add_(0, bins, valid.to(torch.int32))
    agg = agg.to(torch.float32)
    agg_norm = _norm(agg)

    def cos(vec_sum, count):
        mean = vec_sum / torch.clamp_min(count, 1.0)
        denom = _norm(mean) * agg_norm
        c = torch.where(denom > 0.0, (mean * agg).sum() / denom, 0.0)
        return torch.where(count > 0.0, c, 0.0)

    return MetricPack(
        norm_q=_masked_quantiles(norms, valid),
        norm_hist=hist,
        cos_honest=cos(carry["sum_honest"], carry["n_honest"]),
        cos_byz=cos(carry["sum_byz"], carry["n_byz"]),
        n_participants=n,
        n_masked_out=valid.shape[0] - n,
        slab_absmax=carry["slab_absmax"],
        slab_norm_max=carry["slab_norm_max"],
    )


def pack_dense(updates: torch.Tensor, mask: torch.Tensor, byz_mask: torch.Tensor,
               agg: torch.Tensor, num_chunks: int, chunk_size: int) -> MetricPack:
    """The dense round's pack: :func:`pack_update` folded over the streaming
    round's padded chunk layout, chunk after chunk, so a dense and a
    streaming run of the same rows give the same elementwise fields.
    ``updates`` is the matrix the defense consumed; masked-out rows are
    zeroed here, one chunk at a time, as ``Aggregator._sanitize`` zeroes
    them in the streaming round (no second ``[K, D]`` matrix is made)."""
    k, d = updates.shape
    c, chunk, pad = chunk_layout(k, num_chunks)
    if (c, chunk) != (num_chunks, chunk_size):
        raise ValueError(f"pack_dense: {num_chunks} chunks of {chunk_size} is not the "
                         f"layout of {k} rows ({c} of {chunk})")
    mask = torch.as_tensor(mask).to(updates.device, torch.bool)
    byz_mask = byz_mask.to(updates.device)
    carry = pack_init(num_chunks, d, device=updates.device)
    norm_chunks = []
    for j in range(num_chunks):
        rows = slice(j * chunk_size, min((j + 1) * chunk_size, k))
        slab, m, byz = updates[rows], mask[rows], byz_mask[rows]
        if j == num_chunks - 1 and pad:
            slab = torch.cat([slab, slab.new_zeros(pad, d)])
            m = torch.cat([m, m.new_zeros(pad)])
            byz = torch.cat([byz, byz.new_zeros(pad)])
        safe = torch.where(m[:, None], slab, 0.0)
        carry, nj = pack_update(carry, safe, m, byz, j)
        norm_chunks.append(nj)
    norms = torch.cat(norm_chunks)[:k]
    return pack_finalize(carry, norms, mask, agg)


def pack_to_fields(pack: MetricPack) -> Dict[str, Any]:
    """Host side: one pack (tensors or numpy arrays) -> the JSON-ready field
    dict of a ``metrics`` telemetry record."""
    q = np.asarray(_host(pack.norm_q), dtype=np.float64)
    return {
        "norm_min": float(q[0]),
        "norm_q25": float(q[1]),
        "norm_median": float(q[2]),
        "norm_q75": float(q[3]),
        "norm_max": float(q[4]),
        "norm_hist": np.asarray(_host(pack.norm_hist)).astype(int).tolist(),
        "cos_honest": float(_host(pack.cos_honest)),
        "cos_byz": float(_host(pack.cos_byz)),
        "participants": int(_host(pack.n_participants)),
        "masked_out": int(_host(pack.n_masked_out)),
        "slab_absmax": np.asarray(_host(pack.slab_absmax), np.float64).tolist(),
        "slab_norm_max": np.asarray(_host(pack.slab_norm_max), np.float64).tolist(),
    }


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
