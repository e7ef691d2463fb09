"""Ulysses sequence parallelism: head-parallel attention between two
all-to-all reshards.

Counterpart: ``blades_tpu/ops/ulysses.py:1-86`` (``_ulysses_body`` :30-60,
``ulysses_attention`` :63-86); the reference has no long-context path
(``cctnets/utils/transformers.py:8-37``). The sequence-split blocks of
``[B, N, H, Dh]`` (one per device of ``mesh[axis_name]``, as the ring's
harness, ``ops/ring_attention.py:shard_map_seq_attention``) are resliced
so that device ``i`` holds the FULL sequence for its ``H/P`` heads (the
first all-to-all: every block's heads ``i`` moved to device ``i`` and
concatenated along N); each device runs plain full-softmax attention in
float32 over the whole key mask, gathered whole (:46-50); the output is
cast to q's dtype before the reverse reshard (:56-58), which hands every
device its N/P rows of all the heads back. Needs ``H % P == 0``
(:75-80). Local attention is einsum work, plain torch ops, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from blades_tpu_torch.ops.ring_attention import NEG_INF, axis_devices, shard_map_seq_attention


def _ulysses_body(qs, ks, vs, masks, devices, scale: float):
    """The P devices' programs: reshard to head-parallel, attend, reshard
    back."""
    n_dev = len(devices)
    h = qs[0].shape[2]
    heads = [slice(i * (h // n_dev), (i + 1) * (h // n_dev)) for i in range(n_dev)]

    def to_heads(blocks, i):
        # [B, N/P, H, Dh] from every device -> [B, N, H/P, Dh] on device i
        return torch.cat([blk[:, :, heads[i]].to(devices[i], non_blocking=True)
                          for blk in blocks], dim=1)

    full_mask = None
    outs = []
    for i, dev in enumerate(devices):
        q, k, v = to_heads(qs, i), to_heads(ks, i), to_heads(vs, i)
        s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
        if masks[0] is not None:
            # each device holds [B, N/P] of the mask; attention needs all N
            full_mask = torch.cat([m.to(dev, non_blocking=True) for m in masks], dim=1)
            s = torch.where(full_mask[:, None, None, :], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
        # cast BEFORE the reverse reshard: under bf16 it halves the bytes
        outs.append(out.to(qs[0].dtype))
    # [B, N, H/P, Dh] on device i -> [B, N/P, H, Dh] on device j
    n_blk = qs[0].shape[1]
    return [torch.cat([o[:, j * n_blk:(j + 1) * n_blk].to(devices[j], non_blocking=True)
                       for o in outs], dim=2) for j in range(n_dev)]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                      axis_name: str, kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact multi-head attention, the sequence axis split over
    ``mesh[axis_name]``, computed head-parallel. The contract of
    :func:`~blades_tpu_torch.ops.ring_attention.ring_attention`, and H
    must be divisible by the axis size."""
    n_dev = len(axis_devices(mesh, axis_name))
    if q.shape[2] % n_dev:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"'{axis_name}' axis size ({n_dev}); use ring_attention instead"
        )
    return shard_map_seq_attention(_ulysses_body, mesh, axis_name, q, k, v, kv_mask)
