"""Coordinate-wise trimmed mean: Hopper kernel, plain version, dispatch.

Counterpart: ``blades_tpu/ops/pallas_trimmed.py`` — the Pallas TPU kernel
``_trimmed_mean_pallas`` (:91, ``pl.pallas_call`` at :97), its math
``_trim_survivor_mean`` (:53) and the dispatcher ``trimmed_mean`` (:164).

- :func:`trimmed_mean_plain` transcribes ``_trim_survivor_mean`` step for
  step: 2b masked argmax passes (b for the maxima, then b for the minima of
  the rows left, first index on ties), then the sum of the survivors over
  ``K - 2b``. The trimmed extremes never enter the sum. It serves CPU
  tensors, and is the reference the kernel is held against on the card.
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

#: launches of the CUDA kernel in this process: incremented by
#: :func:`trimmed_mean_cuda` where it launches, and nowhere else
trimmed_mean_launches = 0


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
    return torch.where(removed, 0.0, x).sum(dim=0) / (k - 2 * b)


def _check_kernel_args(updates: torch.Tensor, b: int) -> None:
    if updates.dim() != 2 or not updates.is_contiguous():
        raise ValueError(
            f"trimmed_mean_cuda takes a contiguous [K, D] matrix, got shape "
            f"{tuple(updates.shape)} (contiguous={updates.is_contiguous()})"
        )
    k = updates.shape[0]
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


def trimmed_mean(updates: torch.Tensor, b: int) -> torch.Tensor:
    """Coordinate-wise mean of the middle ``K - 2b`` values of ``[K, D]``."""
    k = updates.shape[0]
    if b == 0:
        return updates.mean(dim=0)
    if 2 * b < k and b <= MAX_KERNEL_B:
        if updates.device.type == "cuda":
            return trimmed_mean_cuda(updates.contiguous(), b)
        if updates.device.type == "cpu":
            return trimmed_mean_plain(updates, b)
        raise ValueError(f"no trimmed-mean path for device {updates.device}")
    s = torch.sort(updates, dim=0).values
    return s[b : k - b].mean(dim=0)
