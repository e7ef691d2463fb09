"""The multi-process runtime on ``torch.distributed``.

Counterpart: ``blades_tpu/parallel/distributed.py:1-246`` (``initialize``
:39-114, ``_CLUSTER_ENV_VARS`` :117-124, ``make_global_mesh`` :145-190,
``host_client_slice`` :193-220, ``make_global_client_array`` :223-230,
``sync_global_devices`` :233-238, ``is_coordinator`` :241-246). The
reference's cluster story is "deploy a Ray cluster" (``README.rst:146-149``);
the JAX package joins its hosts into one XLA runtime. The port joins its
processes into one ``torch.distributed`` process group, and every process
runs the same round (``core/engine.py``, the multi-process round): it
trains its own client rows, ``all_gather_into_tensor`` assembles the
``[K, D]`` matrix on every rank, the attack, the aggregation and the server
step run on every rank alike (each model-axis column block on its owner,
broadcast to the others), so every rank holds ``K x D``.

Usage on each process of a job::

    from blades_tpu_torch.parallel import distributed as dist
    dist.initialize("localhost:29500", num_processes=2, process_id=rank,
                    device="cuda")
    mesh = dist.make_global_mesh()      # (clients, model) over every rank
    plan = make_plan(mesh)
    rows = dist.make_global_client_array(x[lo:hi], K, plan)

The backend follows the caller's device: ``nccl`` for CUDA, ``gloo`` for
the CPU; it is never swapped after a failure. NCCL refuses two ranks on one
device, so a one-card machine runs a one-rank NCCL group at most; the gloo
form runs any number of CPU processes. JAX classifies a late call (the XLA
backend touched before ``initialize``, :73-96); torch freezes no backend
before ``init_process_group``, so that branch has no counterpart here.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from blades_tpu_torch.parallel.mesh import (
    CLIENTS_AXIS,
    MODEL_AXIS,
    GlobalClientArray,
    Mesh,
    _as_object_array,
    _this_rank,
    visible_cuda_devices,
)

#: the cluster environment: torchrun's and Slurm's variables, in place of
#: the JAX package's TPU / GKE ones
_CLUSTER_ENV_VARS = (
    "MASTER_ADDR",
    "MASTER_PORT",
    "WORLD_SIZE",
    "RANK",
    "SLURM_JOB_ID",
    "SLURM_NTASKS",
    "SLURM_PROCID",
)


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _autodetect() -> Optional[Tuple[str, int, int]]:
    """``(init_method, world_size, rank)`` from torchrun's variables, then
    Slurm's, or None when the environment names no job."""
    env = os.environ
    if all(env.get(v) for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return (f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                int(env["RANK"]))
    if env.get("SLURM_NTASKS") and env.get("SLURM_PROCID") and env.get("MASTER_ADDR"):
        port = env.get("MASTER_PORT", "29500")
        return (f"tcp://{env['MASTER_ADDR']}:{port}", int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]))
    return None


def _cluster_env_hints() -> list:
    """The cluster variables set in this environment."""
    return [v for v in _CLUSTER_ENV_VARS if os.environ.get(v)]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> None:
    """Join the job's process group. ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` name it;
    with none of them the job comes from the environment (torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, or
    Slurm's), and where the environment names no job this is a no-op, so it
    is safe to call at program start. ``device``: the device this process
    runs on (default the card), which picks the backend (``nccl`` /
    ``gloo``).

    A no-op for ``num_processes == 1`` without a coordinator, and when a
    group is already initialized. With a coordinator and one process it
    makes a one-rank group, which runs the collectives' code path on one
    device. Explicit arguments that fail raise; an autodetected job that
    fails to join warns (its processes would run as independent
    single-process trainings) and stays local."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if num_processes == 1 and coordinator_address is None:
        return
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize needs coordinator_address, num_processes and "
                             "process_id together")
        job = (f"tcp://{coordinator_address}", int(num_processes), int(process_id))
    else:
        job = _autodetect()
        if job is None:
            return  # a single-process run: no job in the environment
    backend = backend_for("cuda" if device is None else device)
    if backend == "nccl":
        dev = torch.device("cuda" if device is None else device)
        torch.cuda.set_device(dev.index or 0)
    try:
        dist.init_process_group(backend, init_method=job[0], world_size=job[1], rank=job[2])
    except (ValueError, RuntimeError) as e:
        if explicit:
            raise
        warnings.warn(
            f"torch.distributed.init_process_group() failed on the job the environment "
            f"names ({', '.join(_cluster_env_hints())}): {e!r}. Proceeding single-process; "
            "if this is a multi-process job, training would silently run unsharded: pass "
            "coordinator_address/num_processes/process_id explicitly.",
            RuntimeWarning,
            stacklevel=2,
        )


def world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_global_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
    dcn_mesh_shape: Optional[Tuple[int, int]] = None,
    local_devices: Optional[Sequence] = None,
) -> Mesh:
    """The (clients, model) mesh over every entry of the job, rank-major:
    ``devices`` is the job's entries as ``(rank, device)`` pairs (default:
    each rank's ``local_devices``, themselves by default every visible CUDA
    device, each rank holding the same list).

    ``dcn_mesh_shape`` (e.g. ``(num_slices, 1)``): the hybrid layout, outer
    axes across slices and inner ones within, exactly the JAX package's
    order for devices without a slice topology (:171-185): entries
    ``[slice-major, intra-slice]`` reshaped ``(cd, md, ci, mi)``,
    transposed ``(0, 2, 1, 3)``, to ``(cd * ci, md * mi)``."""
    if devices is None:
        local = list(local_devices) if local_devices is not None else visible_cuda_devices()
        devices = [(r, d) for r in range(world_size()) for d in local]
    entries = list(devices)
    n = len(entries)
    ranks = np.array([int(r) for r, _ in entries], dtype=np.int64)
    devs = _as_object_array([torch.device(d) for _, d in entries])
    if dcn_mesh_shape is not None:
        if mesh_shape is None:
            mesh_shape = (n // math.prod(dcn_mesh_shape), 1)
        cd, md = dcn_mesh_shape
        ci, mi = mesh_shape
        if cd * md * ci * mi != n:
            raise ValueError(f"hybrid mesh {tuple(dcn_mesh_shape)}x{tuple(mesh_shape)} != "
                             f"{n} devices")
        order = (np.arange(n).reshape(cd, md, ci, mi).transpose(0, 2, 1, 3)
                 .reshape(cd * ci, md * mi))
    else:
        if mesh_shape is None:
            mesh_shape = (n, 1)
        if math.prod(mesh_shape) != n:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} != {n} devices")
        order = np.arange(n).reshape(tuple(mesh_shape))
    return Mesh(devs[order], (CLIENTS_AXIS, MODEL_AXIS), ranks=ranks[order])


def host_client_slice(num_clients: int, mesh: Mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """The half-open ``[lo, hi)`` range of client ids whose data this
    process (``rank``, default its own) must hold, for ``[K, ...]`` arrays
    split over the mesh's clients axis; processes holding the same row
    (model-axis replicas) get the same range."""
    k_shards = mesh.shape[CLIENTS_AXIS]
    if num_clients % k_shards:
        raise ValueError(f"K={num_clients} not divisible by {k_shards} client shards")
    per = num_clients // k_shards
    rank = _this_rank() if rank is None else int(rank)
    ranks = mesh.ranks if mesh.ranks is not None else np.zeros(mesh.devices.shape, np.int64)
    rows = sorted({int(r) for r in np.argwhere(ranks == rank)[:, 0]})
    if not rows:
        raise ValueError(f"rank {rank} holds no entry of {mesh!r}")
    lo, hi = rows[0], rows[-1]
    if rows != list(range(lo, hi + 1)):
        raise ValueError(
            f"this host's devices occupy non-contiguous clients-axis rows "
            f"{rows}; build the mesh so each host owns a contiguous block "
            "(e.g. keep the clients axis slice-major in make_global_mesh)"
        )
    return lo * per, (hi + 1) * per


def make_global_client_array(local_rows, num_clients: int, plan) -> GlobalClientArray:
    """This process's rows of a global ``[K, ...]`` client array (its
    ``host_client_slice`` range) on its primary device, with their range
    and the global K; no process ever holds the other rows."""
    lo, hi = host_client_slice(num_clients, plan.mesh)
    local = torch.as_tensor(np.asarray(local_rows)).to(plan.primary)
    if local.shape[0] != hi - lo:
        raise ValueError(f"{local.shape[0]} local rows for this process's range [{lo}, {hi})")
    return GlobalClientArray(local, lo, hi, int(num_clients))


def sync_global_devices(tag: str = "blades") -> None:
    """A barrier across the job's processes (a no-op in one process)."""
    del tag
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def is_coordinator() -> bool:
    """True on rank 0: gate the host's logging and checkpoint writes."""
    return _this_rank() == 0


def shutdown() -> None:
    """Leave the process group (a no-op when none is initialized)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
