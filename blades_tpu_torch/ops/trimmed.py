"""Coordinate-wise trimmed mean: Hopper kernel, plain version, dispatch.

Counterpart: ``blades_tpu/ops/pallas_trimmed.py`` — the Pallas TPU kernel
``_trimmed_mean_pallas`` (:91, ``pl.pallas_call`` at :97), its math
``_trim_survivor_mean`` (:53) and the dispatcher ``trimmed_mean`` (:164).

- :func:`trimmed_mean_plain` transcribes ``_trim_survivor_mean`` step for
  step: 2b masked argmax passes (b for the maxima, then b for the minima of
  the rows left, first index on ties), then the sum of the survivors over
  ``K - 2b``. The trimmed extremes never enter the sum. The sum is a
  pairwise halving over the rows in elementwise adds (:func:`_column_sum`),
  so each column's value does not depend on the columns beside it: the
  model axis's column blocks (``parallel/mesh.py:aggregate_columns``) give
  the whole matrix's bits on the CPU, as the kernel's do on the card
  (``torch.sum`` over the rows rounds a block's edge columns in another
  order on the CPU). It serves CPU tensors, and is the reference the
  kernel is held against on the card.
- :func:`trimmed_mean_cuda` launches ``csrc/trimmed_mean.cu`` (built on
  first use by ``ops/_build.py``, its C functions bound once when the
  library loads) and counts each launch in :data:`trimmed_mean_launches`.
- :func:`trimmed_mean` dispatches like ``pallas_trimmed.py:164-190``:
  ``b == 0`` is the mean; ``1 <= b <= 16`` with ``2b < K`` goes to the
  kernel for a CUDA tensor and to the plain version for a CPU tensor; a
  larger b is a sort along the client axis and a slice, as in the JAX
  package. The TPU-only condition ``K * 128 <= _VMEM_BUDGET_FLOATS`` is
  dropped: it sized a VMEM tile; the Hopper kernel keeps a column tile of
  :func:`kernel_tile_rows` rows in shared memory, all K rows up to a limit
  and chunks of a larger K streamed through it, so it takes any K. There is
  no compile probe and no switch to turn the kernel off: on a CUDA tensor
  the kernel runs or the call raises.

The batch over S experiments (``ExperimentBatch(mode="vmap")``; JAX's
``jax.vmap`` of the ``pallas_call`` adds a grid axis):

- :func:`trimmed_mean_batched_plain` is :func:`trimmed_mean_plain` per
  experiment of an ``[S, K, D]`` stack, stacked;
- :func:`trimmed_mean_batched_cuda` makes ONE launch of the kernel's
  batched entry (``blades_trimmed_mean_batched_f32``: the grid's y axis is
  the experiment) over the contiguous stack, counted once in
  :data:`trimmed_mean_launches` and once in
  :data:`trimmed_mean_batched_launches`;
- :func:`trimmed_mean_batched` dispatches as :func:`trimmed_mean` does;
- the kernel route of :func:`trimmed_mean` goes through the custom op
  ``blades::trimmed_mean``, whose vmap rule sends an ``[S, K, D]`` batch
  to :func:`trimmed_mean_batched`, so ``torch.func.vmap(trimmed_mean)``
  is one launch too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blades_tpu_torch.ops import _build

#: b above this takes the sort path (b is a template parameter of the
#: kernel, one instantiation each; same cap as
#: ``pallas_trimmed._MAX_UNROLL_B``)
MAX_KERNEL_B = 16

#: experiments of one batched launch (the grid's y extent)
MAX_BATCH = 65535

#: launches of the CUDA kernel in this process: incremented by
#: :func:`trimmed_mean_cuda` and :func:`trimmed_mean_batched_cuda` where they
#: launch it, and nowhere else
trimmed_mean_launches = 0

#: the batched entry's launches among them (one per :func:`trimmed_mean_batched_cuda`)
trimmed_mean_batched_launches = 0


def _column_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the rows of ``[K, D]``, per column in an order that K
    alone fixes: the first half of the rows added to the second (an odd
    last row into the first sum), until one row is left."""
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        top = x[:half] + x[half:2 * half]
        if x.shape[0] % 2:
            top[0] += x[2 * half]
        x = top
    return x[0]


def trimmed_mean_plain(updates: torch.Tensor, b: int) -> torch.Tensor:
    """Mean of the rows that survive a 2b-extremum trim, per column."""
    x = updates.to(torch.float32)
    k = x.shape[0]
    rows = torch.arange(k, device=x.device)[:, None]
    removed = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    neg_inf = torch.tensor(float("-inf"), device=x.device)
    for sign in (1.0, -1.0):
        for _ in range(b):
            masked = torch.where(removed, neg_inf, sign * x)
            idx = torch.argmax(masked, dim=0)  # first index among equal maxima
            removed = removed | (rows == idx[None, :])
    return _column_sum(torch.where(removed, 0.0, x)) / (k - 2 * b)


def trimmed_mean_batched_plain(updates: torch.Tensor, b: int) -> torch.Tensor:
    """:func:`trimmed_mean_plain` of each ``[K, D]`` slab of an ``[S, K, D]``
    stack: ``[S, D]``."""
    return torch.stack([trimmed_mean_plain(u, b) for u in updates])


def _check_kernel_args(updates: torch.Tensor, b: int, batched: bool = False) -> None:
    name, dims, what = (("trimmed_mean_batched_cuda", 3, "[S, K, D] stack") if batched
                        else ("trimmed_mean_cuda", 2, "[K, D] matrix"))
    if updates.dim() != dims or not updates.is_contiguous():
        raise ValueError(
            f"{name} takes a contiguous {what}, got shape "
            f"{tuple(updates.shape)} (contiguous={updates.is_contiguous()})"
        )
    if batched and not 1 <= updates.shape[0] <= MAX_BATCH:
        raise ValueError(f"{name} takes 1 to {MAX_BATCH} experiments, got {updates.shape[0]}")
    k = updates.shape[-2]
    if not 1 <= b <= MAX_KERNEL_B or 2 * b >= k:
        raise ValueError(
            f"trimmed_mean_cuda needs 1 <= b <= {MAX_KERNEL_B} and 2b < K; "
            f"got b={b}, K={k}"
        )
    if updates.dtype != torch.float32:
        raise TypeError(f"trimmed_mean_cuda takes float32, got {updates.dtype}")
    if updates.device.type != "cuda":
        raise ValueError(f"trimmed_mean_cuda needs a CUDA tensor, got {updates.device}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built and loaded once, its functions bound."""
    lib = _build.load("trimmed_mean")
    lib.blades_trimmed_mean_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.blades_trimmed_mean_f32.restype = ctypes.c_int
    lib.blades_trimmed_mean_batched_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.blades_trimmed_mean_batched_f32.restype = ctypes.c_int
    lib.blades_trimmed_mean_tile_rows.argtypes = [ctypes.c_int64]
    lib.blades_trimmed_mean_tile_rows.restype = ctypes.c_int
    return lib


def kernel_tile_rows(k: int) -> int:
    """Rows of a column tile the kernel keeps in shared memory at K=k: k
    itself when the tile fits (the matrix is read once), else the chunk it
    streams (the matrix is read once per pass)."""
    return _library().blades_trimmed_mean_tile_rows(k)


def trimmed_mean_cuda(updates: torch.Tensor, b: int) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream."""
    global trimmed_mean_launches
    _check_kernel_args(updates, b)
    k, d = updates.shape
    out = torch.empty(d, dtype=torch.float32, device=updates.device)
    fn = _library().blades_trimmed_mean_f32
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        status = fn(updates.data_ptr(), out.data_ptr(), k, d, b, stream)
    if status != 0:
        raise RuntimeError(
            f"trimmed_mean kernel launch failed: cudaError_t {status} "
            f"(K={k}, D={d}, b={b})"
        )
    trimmed_mean_launches += 1
    return out


def trimmed_mean_batched_cuda(updates: torch.Tensor, b: int) -> torch.Tensor:
    """ONE launch of the kernel's batched entry over an ``[S, K, D]`` stack
    on PyTorch's current stream: ``[S, D]``."""
    global trimmed_mean_launches, trimmed_mean_batched_launches
    _check_kernel_args(updates, b, batched=True)
    n, k, d = updates.shape
    out = torch.empty((n, d), dtype=torch.float32, device=updates.device)
    fn = _library().blades_trimmed_mean_batched_f32
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        status = fn(updates.data_ptr(), out.data_ptr(), n, k, d, b, stream)
    if status != 0:
        raise RuntimeError(
            f"batched trimmed_mean kernel launch failed: cudaError_t {status} "
            f"(S={n}, K={k}, D={d}, b={b})"
        )
    trimmed_mean_launches += 1
    trimmed_mean_batched_launches += 1
    return out


def _kernel_route(k: int, b: int) -> bool:
    """The kernel (or, on the CPU, its plain version) serves this K and b."""
    return 1 <= b <= MAX_KERNEL_B and 2 * b < k


@torch.library.custom_op("blades::trimmed_mean", mutates_args=())
def _trimmed_mean_op(updates: torch.Tensor, b: int) -> torch.Tensor:
    """The kernel route of :func:`trimmed_mean` as an operator, so that
    ``torch.func.vmap`` reaches its batching rule below."""
    if updates.device.type == "cuda":
        return trimmed_mean_cuda(updates.contiguous(), b)
    if updates.device.type == "cpu":
        return trimmed_mean_plain(updates, b)
    raise ValueError(f"no trimmed-mean path for device {updates.device}")


@_trimmed_mean_op.register_fake
def _(updates, b):
    return updates.new_empty(updates.shape[1:], dtype=torch.float32)


@_trimmed_mean_op.register_vmap
def _(info, in_dims, updates, b):
    """``[..., K, D]`` under vmap: the batch dims in front, flattened into
    one experiment axis of :func:`trimmed_mean_batched` (one launch)."""
    if in_dims[0] is None:
        return _trimmed_mean_op(updates, b), None
    lead = updates.movedim(in_dims[0], 0)
    k, d = lead.shape[-2:]
    out = trimmed_mean_batched(lead.reshape(-1, k, d), b)
    return out.reshape(lead.shape[:-2] + (d,)), 0


def trimmed_mean(updates: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise mean of the middle ``K - 2b`` values of ``[K, D]``."""
    k = updates.shape[0]
    if b == 0:
        return updates.mean(dim=0)
    if _kernel_route(k, b):
        return _trimmed_mean_op(updates, b)
    s = torch.sort(updates, dim=0).values
    return s[b : k - b].mean(dim=0)


def trimmed_mean_batched(updates: torch.Tensor, b: int) -> torch.Tensor:
    """:func:`trimmed_mean` of each ``[K, D]`` slab of an ``[S, K, D]``
    stack: ``[S, D]``; on a CUDA tensor the kernel route is ONE launch for
    the S slabs, on a CPU tensor :func:`trimmed_mean_batched_plain`."""
    k = updates.shape[1]
    if b == 0:
        return updates.mean(dim=1)
    if _kernel_route(k, b):
        if updates.device.type == "cuda":
            return trimmed_mean_batched_cuda(updates.contiguous(), b)
        if updates.device.type == "cpu":
            return trimmed_mean_batched_plain(updates, b)
        raise ValueError(f"no trimmed-mean path for device {updates.device}")
    s = torch.sort(updates, dim=1).values
    return s[:, b : k - b].mean(dim=1)
