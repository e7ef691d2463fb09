"""The (clients, model) device mesh and the sharding plan of a round.

Counterpart: ``blades_tpu/parallel/mesh.py:1-102`` (``CLIENTS_AXIS`` /
``MODEL_AXIS`` :32-33, ``make_mesh`` :36-54, ``auto_mesh_shape`` :57-63,
``ShardingPlan`` :66-88, ``make_plan`` :91-102). The JAX package hands XLA
a ``jax.sharding.Mesh`` and ``NamedSharding``s and lets GSPMD place the
round; the port places it itself, so the plan says where each part runs:

- ``clients``: the federated population axis. Client row ``i`` of a
  ``[K, ...]`` family belongs to the clients-axis row whose contiguous range
  holds it (:meth:`ShardingPlan.row_ranges`), and that row's device
  (``devices[r, 0]``) trains it from its replica of the params
  (``core/engine.py``).
- ``model``: the flat parameter axis D. Where the defense takes the trimmed
  mean's kernel route, the ``[K, D]`` matrix is aggregated in ``m``
  contiguous column blocks, block ``j`` on ``devices[0, j]``
  (:meth:`ShardingPlan.aggregate_columns`); every other defense runs on the
  whole matrix on the primary device ``devices[0, 0]``.

:class:`Mesh` stands in for ``jax.sharding.Mesh``: a numpy object array of
``torch.device`` with axis names, and each entry's process rank
(``parallel/distributed.py:make_global_mesh``; 0 everywhere in one
process). Entries may repeat: ``[torch.device("cpu")] * 8`` on the CPU or
``[torch.device("cuda", 0)] * 4`` on one card is the virtual mesh, the
counterpart of JAX's forced host-platform devices
(``tests/conftest.py:29``). On a virtual mesh every ``.to()`` is a no-op,
so a sharded round there costs the partitioning alone, not transfers.

:class:`GlobalClientArray` is the one way the port indexes a ``[K, ...]``
family by client rows when it is not one tensor: consecutive pieces, each
on its own device (one piece of a process's rows in a job mesh,
``parallel/distributed.py:make_global_client_array``; one piece per
clients-axis row on that row's device, :meth:`ShardingPlan.place_rows`, the
store and the batches of ``datasets/fl.py:FLDataset.place``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._pytree import register_pytree_node, tree_leaves, tree_map

CLIENTS_AXIS = "clients"
MODEL_AXIS = "model"


def _as_object_array(entries) -> np.ndarray:
    flat = list(np.ravel(np.asarray(entries, dtype=object)))
    out = np.empty(len(flat), dtype=object)
    for i, e in enumerate(flat):
        out[i] = e
    return out


class Mesh:
    """Named device axes over an object array of ``torch.device``.

    ``devices``: an array (or nested sequence) of ``torch.device`` (or
    device strings), shaped by the axes; ``axis_names``: one name per axis;
    ``ranks``: the process of each entry (``make_global_mesh``), None in a
    mesh of this process alone. ``mesh.shape[name]`` is the axis's size."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        arr = np.asarray(devices, dtype=object)
        shape = arr.shape
        flat = _as_object_array(arr)
        for i, d in enumerate(flat):
            flat[i] = torch.device(d)
        self.devices = flat.reshape(shape)
        self.axis_names = tuple(str(a) for a in axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names {self.axis_names} for a "
                             f"{self.devices.ndim}-d device array {shape}")
        self.ranks = None if ranks is None else np.asarray(ranks, dtype=np.int64).reshape(shape)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices in order of first appearance, each once."""
        return list(dict.fromkeys(np.ravel(self.devices)))

    def fingerprint(self) -> dict:
        """The mesh as the engine cache keys it (``blades_tpu/simulator.py:
        653-670``): axis names, shape, the entries and their ranks."""
        return {"axis_names": list(self.axis_names),
                "shape": [int(s) for s in self.devices.shape],
                "devices": [str(d) for d in np.ravel(self.devices)],
                "ranks": None if self.ranks is None else [int(r) for r in np.ravel(self.ranks)]}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.distinct_devices()]})"


def visible_cuda_devices() -> List[torch.device]:
    """Every CUDA device this process sees; raises where there is none, as
    the port never picks the CPU by itself."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is visible; pass devices= explicitly (a virtual mesh "
            "repeats one device, e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices: Optional[Sequence] = None, mesh_shape: Optional[tuple] = None) -> Mesh:
    """A (clients, model) mesh over ``devices`` (default: every visible
    CUDA device), shaped ``mesh_shape`` (default ``(n, 1)``: all on the
    clients axis). Entries may repeat (a virtual mesh)."""
    if devices is None:
        devices = visible_cuda_devices()
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n, 1)
    if mesh_shape[0] * mesh_shape[1] != n:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} != {n} devices")
    arr = _as_object_array(list(devices)).reshape(tuple(mesh_shape))
    return Mesh(arr, (CLIENTS_AXIS, MODEL_AXIS))


def auto_mesh_shape(n_devices: int, num_clients: int) -> tuple:
    """The largest clients-axis width dividing both the device count and
    K; the devices left over go to the model axis."""
    c = math.gcd(n_devices, num_clients)
    return (c, n_devices // c)


def split_ranges(n: int, parts: int) -> List[slice]:
    """``parts`` contiguous ranges covering ``range(n)``, the first
    ``n % parts`` one longer (``np.array_split``'s layout)."""
    base, extra = divmod(int(n), int(parts))
    out, lo = [], 0
    for i in range(parts):
        hi = lo + base + (i < extra)
        out.append(slice(lo, hi))
        lo = hi
    return out


class GlobalClientArray:
    """Client rows ``[lo, hi)`` of a global ``[K, ...]`` client array, held
    as consecutive pieces, each a tensor on its own device (``local``: one
    tensor, or the pieces in client order). No piece holds a row outside
    ``[lo, hi)``, and ``shape`` is the global one. Indexing with a slice of
    global client ids (or one id) that lies inside one piece reads those
    rows where they are, a view with no copy; a range outside ``[lo, hi)``
    or across pieces raises ``IndexError``. The round engine takes it in
    place of ``cx`` / ``cy`` (``core/engine.py``) and reads each mesh row's
    part from its piece."""

    def __init__(self, local, lo: int, hi: int, num_clients: int):
        self.pieces = (local,) if isinstance(local, torch.Tensor) else tuple(local)
        self.lo, self.hi, self.num_clients = int(lo), int(hi), int(num_clients)
        self.starts = [self.lo]
        for piece in self.pieces:
            self.starts.append(self.starts[-1] + int(piece.shape[0]))
        if self.starts[-1] != self.hi:
            raise ValueError(f"pieces of {self.starts[-1] - self.lo} rows for the range "
                             f"[{self.lo}, {self.hi})")

    @property
    def local(self) -> torch.Tensor:
        """The rows as one tensor: the piece itself where there is one, else
        the pieces concatenated on the first piece's device (a copy)."""
        if len(self.pieces) == 1:
            return self.pieces[0]
        dev = self.pieces[0].device
        return torch.cat([_to(p, dev) for p in self.pieces])

    @property
    def shape(self) -> tuple:
        return (self.num_clients,) + tuple(self.pieces[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def __getitem__(self, index):
        rows, rest = (index[0], index[1:]) if isinstance(index, tuple) else (index, ())
        one = isinstance(rows, int)
        if one:
            rows = slice(rows, rows + 1)
        if not isinstance(rows, slice) or rows.step not in (None, 1):
            raise IndexError(f"rows {rows}: a slice of client ids or one id")
        start = self.lo if rows.start is None else rows.start
        stop = self.hi if rows.stop is None else rows.stop
        if start < self.lo or stop > self.hi:
            raise IndexError(f"rows {rows} outside this array's [{self.lo}, {self.hi})")
        for piece, a, b in zip(self.pieces, self.starts, self.starts[1:]):
            if a <= start and stop <= b:
                local = piece[start - a: stop - a]
                if rest:
                    local = local[(slice(None),) + rest]
                return local[0] if one else local
        raise IndexError(f"rows {rows} span pieces of {self.starts}: read each mesh row's "
                         "part alone (ShardingPlan.split_rows)")

    def __repr__(self) -> str:
        pieces = [(a, b, str(p.device))
                  for p, a, b in zip(self.pieces, self.starts, self.starts[1:])]
        return f"GlobalClientArray(rows [{self.lo}, {self.hi}) of {self.num_clients}, {pieces})"


def _unflatten_rows(pieces, ctx) -> GlobalClientArray:
    # no checks: vmap unflattens its in_dims, ints, into the tree
    a = GlobalClientArray.__new__(GlobalClientArray)
    a.pieces = tuple(pieces)
    a.lo, a.hi, a.num_clients, starts = ctx
    a.starts = list(starts)
    return a


# a pytree node whose leaves are its pieces: tree_map, tree_leaves and
# vmap's pass-through of an unbatched input see its tensors
register_pytree_node(
    GlobalClientArray,
    lambda a: (list(a.pieces), (a.lo, a.hi, a.num_clients, tuple(a.starts))),
    _unflatten_rows,
    serialized_type_name="blades_tpu_torch.parallel.mesh.GlobalClientArray",
)


def _this_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Where each array family of a federated round lives: the port's form
    of the JAX plan's ``NamedSharding``s (``replicated``, ``clients``,
    ``updates``, ``flat_model``).

    In a job mesh (``mesh.ranks`` set, a process group initialized) this
    process owns the entries of its rank: it trains the client rows of
    those clients-axis rows and aggregates the column blocks whose
    ``devices[0, j]`` is its own; its primary device is its first entry."""

    mesh: Mesh

    @property
    def clients_width(self) -> int:
        return int(self.mesh.devices.shape[0])

    @property
    def model_width(self) -> int:
        return int(self.mesh.devices.shape[1])

    @property
    def collective(self) -> bool:
        """True in a job mesh of an initialized process group: the round's
        rows are gathered with collectives (``core/engine.py``)."""
        dist = torch.distributed
        return (self.mesh.ranks is not None and dist.is_available()
                and dist.is_initialized())

    @property
    def rank(self) -> int:
        return _this_rank() if self.collective else 0

    def owns(self, index: Tuple[int, int]) -> bool:
        """This process runs mesh entry ``index``."""
        return not self.collective or int(self.mesh.ranks[index]) == self.rank

    @property
    def primary(self) -> torch.device:
        """The device of the round's replicated work: ``devices[0, 0]``, or
        in a job mesh this process's first entry."""
        if not self.collective:
            return self.mesh.devices[0, 0]
        hit = np.argwhere(self.mesh.ranks == self.rank)
        if not len(hit):
            raise ValueError(f"rank {self.rank} holds no entry of {self.mesh!r}")
        return self.mesh.devices[tuple(hit[0])]

    def row_device(self, r: int) -> torch.device:
        """The device of clients-axis row ``r``."""
        return self.mesh.devices[r, 0]

    def row_ranges(self, n: int) -> List[slice]:
        """The contiguous client range of each clients-axis row, for ``n``
        clients."""
        return split_ranges(n, self.clients_width)

    def column_ranges(self, d: int) -> List[slice]:
        """The contiguous columns of each model-axis block of ``[K, d]``:
        ``ceil(d / m)`` first, then ``floor(d / m)``."""
        return split_ranges(d, self.model_width)

    def split_rows(self, rows: slice, num_clients: int) -> List[Tuple[int, slice]]:
        """``rows`` (a slice of ``range(num_clients)``) cut at the
        clients-axis rows' ranges: ``[(row, part)]`` in client order, the
        empty parts and the rows of other processes left out."""
        out = []
        for r, rng in enumerate(self.row_ranges(num_clients)):
            lo, hi = max(rows.start, rng.start), min(rows.stop, rng.stop)
            if lo < hi and self.owns((r, 0)):
                out.append((r, slice(lo, hi)))
        return out

    def process_rows(self, num_clients: int) -> slice:
        """The contiguous client range this process trains: every row in one
        process; in a job mesh the rows of its rank, which must be
        contiguous (``parallel/distributed.py:host_client_slice``)."""
        parts = self.split_rows(slice(0, num_clients), num_clients)
        if not parts:
            raise ValueError(f"this process trains no client row of {self.mesh!r}")
        for (_, a), (_, b) in zip(parts, parts[1:]):
            if a.stop != b.start:
                raise ValueError(
                    f"this process's clients-axis rows of {self.mesh!r} are not contiguous; "
                    "build the mesh rank-major (make_global_mesh)")
        return slice(parts[0][1].start, parts[-1][1].stop)

    def replicate(self, tree) -> list:
        """One replica of ``tree`` per clients-axis row, on the row's
        device; a replica on the tree's own device is the tree itself."""
        return [tree_map(lambda t: _to(t, self.row_device(r)), tree)
                for r in range(self.clients_width)]

    def shard_batch(self, tree, rows: Optional[slice] = None,
                    num_clients: Optional[int] = None) -> List[Tuple[int, slice, object]]:
        """A tree whose tensor leaves lead with the client rows ``rows`` of
        ``range(num_clients)`` (default: every client, K the first leaf's
        leading size), cut at the clients-axis rows (:meth:`split_rows`):
        ``[(row, part, piece)]`` in client order, ``part`` the piece's
        client range and ``piece`` its slice of ``tree`` on the row's device
        (a view where it is there already); other leaves pass through."""
        if rows is None:
            num_clients = next(t for t in tree_leaves(tree)
                               if isinstance(t, torch.Tensor)).shape[0]
            rows = slice(0, num_clients)
        out = []
        for r, part in self.split_rows(rows, num_clients):
            at, dev = slice(part.start - rows.start, part.stop - rows.start), self.row_device(r)
            out.append((r, part, tree_map(
                lambda t: _to(t[at], dev) if isinstance(t, torch.Tensor) else t, tree)))
        return out

    def place_rows(self, t: torch.Tensor, copy: bool = False) -> GlobalClientArray:
        """The ``[K, ...]`` tensor ``t`` laid out by the clients-axis rows:
        each row's contiguous range (:meth:`row_ranges`) on the row's
        device, a view where it is there already; in a job mesh only this
        process's rows (:meth:`process_rows`). ``copy``: every piece a copy
        of its own, so that ``t`` can be freed."""
        k = int(t.shape[0])
        rows = self.process_rows(k)
        return GlobalClientArray(
            [t[part].to(self.row_device(r), non_blocking=True, copy=copy)
             for r, part in self.split_rows(slice(0, k), k)], rows.start, rows.stop, k)

    def aggregate_columns(self, updates: torch.Tensor,
                          fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """``fn`` (a column-separable ``[K, d] -> [d]``) over the model-axis
        column blocks of ``updates``: block ``j`` on ``devices[0, j]``, the
        ``[D]`` results concatenated on the primary device. In a job mesh
        each block's owner computes it and broadcasts it to the others."""
        dev0 = self.primary
        outs = []
        for j, cols in enumerate(self.column_ranges(updates.shape[1])):
            block_dev = self.mesh.devices[0, j]
            if self.owns((0, j)):
                out = fn(_to(updates[:, cols], block_dev).contiguous())
                out = _to(out, dev0)
            else:
                out = torch.empty(cols.stop - cols.start, dtype=torch.float32, device=dev0)
            if self.collective:
                torch.distributed.broadcast(out, src=int(self.mesh.ranks[0, j]))
            outs.append(out)
        return torch.cat(outs)


def _to(t, device):
    return t.to(device, non_blocking=True) if isinstance(t, torch.Tensor) else t


def make_plan(mesh: Optional[Mesh] = None) -> ShardingPlan:
    """The plan of ``mesh`` (default :func:`make_mesh`)."""
    return ShardingPlan(mesh=make_mesh() if mesh is None else mesh)
