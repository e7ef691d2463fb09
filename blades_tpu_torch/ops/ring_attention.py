"""Ring attention: sequence-parallel exact attention over a mesh axis.

Counterpart: ``blades_tpu/ops/ring_attention.py:1-140`` (``_block_update``
:31-42, ``_ring_body`` :45-63, ``shard_map_seq_attention`` :66-111,
``ring_attention`` :114-129, ``attention_reference`` :132-140). The
reference has no long-context path (its attention runs over at most 256
tokens on one device, ``cctnets/utils/transformers.py:8-37``).

The sequence axis N of ``[B, N, H, Dh]`` is split into P contiguous blocks,
one per device of ``mesh[axis_name]``. Each device keeps its Q block and
folds in one K/V block per step with the online-softmax recurrence (running
max ``m``, normalizer ``l``, output ``o``, float32 accumulators); after
each step every K/V block, with its block of the key mask, moves to the
next device of the ring (``.to(next, non_blocking=True)``, the
counterpart of ``lax.ppermute``). After P steps every Q block has seen
every K/V block. The JAX package runs it under ``shard_map``, one program
per device; the port runs the P devices' steps from one Python loop, and
autograd flows through the block moves. On a virtual mesh (one device
repeated) each move is a no-op. The block update is einsum work, as in
the JAX package: plain torch ops, not a kernel (``scaled_dot_product
_attention`` does not expose the running max and normalizer the fold
needs).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

NEG_INF = -1e30


def _block_update(q, k, v, kv_mask, m, l, o, scale):
    """Fold one K/V block into the online-softmax accumulator."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale  # [B, H, Nq, Nk]
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    m_cur = s.amax(dim=-1)  # [B, H, Nq]
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)  # rescale of the old accumulator
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.to(p.dtype))
    return m_new, l_new, o_new


def _ring_body(qs, ks, vs, masks, devices, scale: float) -> List[torch.Tensor]:
    """The P devices' programs: block ``i`` of Q on ``devices[i]``, the K/V
    (and mask) blocks rotating to the next device after every step."""
    n_dev = len(devices)
    acc = []
    for q in qs:
        b, nq, h, d = q.shape
        acc.append((torch.full((b, h, nq), NEG_INF, dtype=torch.float32, device=q.device),
                    torch.zeros((b, h, nq), dtype=torch.float32, device=q.device),
                    torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)))
    for _ in range(n_dev):
        acc = [_block_update(qs[i], ks[i], vs[i], masks[i], *acc[i], scale)
               for i in range(n_dev)]
        # device i's blocks go to device i + 1: device i now holds i - 1's
        move = lambda blocks: [  # noqa: E731
            None if blocks[i - 1] is None
            else blocks[i - 1].to(devices[i], non_blocking=True) for i in range(n_dev)]
        ks, vs, masks = move(ks), move(vs), move(masks)
    outs = []
    for q, (_, l, o) in zip(qs, acc):
        # [B, H, Nq, D] -> [B, Nq, H, D]; guard fully-masked rows (l == 0)
        out = o / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return outs


def axis_devices(mesh, axis_name: str) -> list:
    """The devices along ``mesh``'s axis ``axis_name`` (the first entry of
    every other axis)."""
    axis = mesh.axis_names.index(axis_name)
    index = [0] * mesh.devices.ndim
    out = []
    for i in range(mesh.devices.shape[axis]):
        index[axis] = i
        out.append(mesh.devices[tuple(index)])
    return out


def shard_map_seq_attention(body_fn: Callable, mesh, axis_name: str, q, k, v,
                            kv_mask=None) -> torch.Tensor:
    """The block-split harness both schedules share (the ring here, the
    all-to-all in ``ops/ulysses.py``): q, k, v ``[B, N, H, Dh]`` and the
    ``[B, N]`` mask are split along N into one block per device of
    ``mesh[axis_name]`` and moved there; ``body_fn(qs, ks, vs, masks,
    devices, scale)`` returns each device's ``[B, N/P, H, Dh]`` output
    block, and the blocks are concatenated on q's device."""
    devices = axis_devices(mesh, axis_name)
    n_dev, n = len(devices), q.shape[1]
    if n % n_dev:
        raise ValueError(f"sequence length {n} not divisible by the '{axis_name}' axis "
                         f"size ({n_dev})")
    scale = q.shape[-1] ** -0.5

    def split(t):
        if t is None:
            return [None] * n_dev
        return [blk.to(dev, non_blocking=True)
                for blk, dev in zip(torch.chunk(t, n_dev, dim=1), devices)]

    outs = body_fn(split(q), split(k), split(v), split(kv_mask), devices, scale)
    return torch.cat([o.to(q.device, non_blocking=True) for o in outs], dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis_name: str,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact multi-head attention with the sequence axis split over
    ``mesh[axis_name]``. ``q`` / ``k`` / ``v``: ``[B, N, H, Dh]`` (N
    divisible by the axis size); ``kv_mask``: optional ``[B, N]`` bool
    (True = a valid key). Returns ``[B, N, H, Dh]`` on q's device, in q's
    dtype."""
    return shard_map_seq_attention(_ring_body, mesh, axis_name, q, k, v, kv_mask)


def attention_reference(q, k, v, kv_mask=None) -> torch.Tensor:
    """Single-device full-softmax attention (the testing oracle)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
