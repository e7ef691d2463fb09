"""FLDataset: the runtime federated dataset, resident on the run's device.

Counterpart: ``blades_tpu/datasets/fl.py:35-317`` (``FLDataset``;
``_make_sample_fn`` :163-207, ``traceable_sampler`` :209, ``sample_round``
:221, ``get_train_data`` :236-266, ``get_all_test_data`` :268,
``client_test_slices`` :279, ``from_client_arrays`` :290-317). All K
clients' train data is one padded ``[K, N_max, ...]`` tensor family in the
store's own dtype (uint8 for images), and a round's batches for every
client come from one gather.

Sampling: each round draws, per client, a fresh without-replacement order of
its samples (uniform draws argsorted, padding pushed last) and indexes it
modulo the client's sample count (wraparound past one local epoch). Then
the optional ``transform`` augments the flattened ``[K * S * B, ...]``
batch, drawing from the same generator after the order (the JAX sampler's
``ku, kt = split(key)``), and ``normalize`` casts and standardizes it. A
round is a pure function of the ``torch.Generator`` it is given; the bits
differ from the JAX sampler's, so tests that compare the packages inject
the draws.

Placement (:meth:`FLDataset.place`, JAX :110-145): the train store laid out
by the mesh's clients-axis rows, each row's clients on the row's device,
and a sampler that returns a batch laid out the same way
(``parallel/mesh.py:GlobalClientArray``). Its batches are the unplaced
sampler's bit for bit: it makes the same draws from the one generator, in
the same order, on the primary device (the order draws ``u`` for all K
clients, then the transform's parameters for all ``K * S * B`` images,
through the transform's split form ``draw`` / ``apply``), and only the
gather, the transform's application and the normalizer run per row, on the
row's device, on the row's slice of those draws.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from blades_tpu_torch.datasets.augment import eager_normalize
from blades_tpu_torch.parallel.mesh import GlobalClientArray
from blades_tpu_torch.telemetry import programs as _programs

_STORE = ("train_x", "train_y", "train_counts", "test_x_raw", "test_y")
#: the arrays place() lays out by mesh rows (JAX places the train arrays only)
_PLACED = ("train_x", "train_y", "train_counts")


def _gather(u, train_x, train_y, counts, need: int):
    """Each client's ``need`` samples for a round: its fresh
    without-replacement order (the uniform draws ``u [n, N_max]``
    argsorted, padding pushed last), indexed modulo its sample count
    (wraparound past one local epoch). Returns ``cx [n, need, ...]`` and
    ``cy [n, need]`` from the store rows ``train_x`` / ``train_y``."""
    n, n_max = u.shape
    dev = u.device
    pad = torch.arange(n_max, device=dev)[None, :] >= counts[:, None]
    order = torch.argsort(torch.where(pad, torch.inf, u), dim=1, stable=True)
    pos = torch.arange(need, device=dev)[None, :] % torch.clamp_min(counts[:, None], 1)
    idx = torch.gather(order, 1, pos)  # [n, need]
    return train_x[torch.arange(n, device=dev)[:, None], idx], torch.gather(train_y, 1, idx)


class FLDataset:
    """Device-resident federated dataset.

    ``train_x``/``train_y``: per-client padded arrays ``[K, N_max, ...]`` /
    ``[K, N_max]``; ``train_counts``: ``[K]`` true sample counts (padding is
    never sampled); ``test_x``/``test_y``: the union test set ordered by
    owning client, client i owning ``test_counts[i]`` rows (default: an even
    split of the union). ``transform``: optional batched train augmentation
    ``(x [N, ...], generator) -> x`` applied at sampling time (the JAX
    package's is per image, ``(key, x) -> x``, and vmapped); ``normalize``:
    optional ``(x) -> x`` cast and standardization applied after it (images
    are stored uint8; a :class:`~blades_tpu_torch.datasets.augment.Normalizer`
    multiplies by its reciprocal in the sampler and divides for the test set
    and ``get_train_data``, as the jitted and the eager JAX calls do).
    ``pad_id``: the padding token of text data (None for images).
    """

    def __init__(
        self,
        train_x: np.ndarray,
        train_y: np.ndarray,
        train_counts: np.ndarray,
        test_x: np.ndarray,
        test_y: np.ndarray,
        transform: Optional[Callable] = None,
        normalize: Optional[Callable] = None,
        client_ids: Optional[List] = None,
        pad_id: Optional[int] = None,
        test_counts: Optional[np.ndarray] = None,
        device="cpu",
    ):
        self.device = torch.device(device)
        self.train_x = torch.as_tensor(train_x).to(self.device)
        self.train_y = torch.as_tensor(train_y).to(self.device)
        self.train_counts = torch.as_tensor(train_counts, dtype=torch.int64).to(self.device)
        self.test_x_raw = torch.as_tensor(test_x).to(self.device)
        self.test_y = torch.as_tensor(test_y).to(self.device)
        self.transform = transform
        self.normalize = normalize
        self.pad_id = pad_id
        self.num_clients = int(self.train_x.shape[0])
        self.client_ids = (
            list(client_ids) if client_ids is not None else list(range(self.num_clients))
        )
        n_test = int(self.test_y.shape[0])
        if test_counts is None:
            test_counts = np.array(
                [len(s) for s in np.array_split(np.arange(n_test), self.num_clients)],
                np.int64,
            )
        self.test_counts = np.asarray(test_counts, np.int64)
        if len(self.test_counts) != self.num_clients:
            raise ValueError(
                f"test_counts has {len(self.test_counts)} entries for "
                f"{self.num_clients} clients"
            )
        if int(self.test_counts.sum()) != n_test:
            raise ValueError(
                f"test_counts sum {int(self.test_counts.sum())} != union test "
                f"size {n_test}"
            )
        self._samplers = {}
        # place(): the layout the train store is laid out in (the plan's
        # clients-axis rows, JAX's _sharding), None while it is whole; and
        # why the last place() call left the store whole
        self._placement = None
        self.place_skipped: Optional[str] = None
        self.test_offsets = np.concatenate(
            [[0], np.cumsum(self.test_counts)[:-1]]
        ).astype(np.int64)
        # per-client host-side epoch streams of get_train_data
        self._streams: Dict[int, dict] = {}

    def to(self, device) -> "FLDataset":
        """Move the data store to ``device`` (in place; returns self). A
        store that moves drops its samplers, which hold its old tensors. A
        placed store is gathered whole on ``device`` (un-placed); one
        placed for a job mesh holds only its process's rows and raises."""
        if self._placement is not None and (
                (self.train_x.lo, self.train_x.hi) != (0, self.num_clients)):
            raise ValueError(
                f"the store holds only the client rows [{self.train_x.lo}, "
                f"{self.train_x.hi}) of {self.num_clients} (placed for a job mesh); "
                "it cannot be gathered on one device")
        self.device = torch.device(device)
        if self._placement is not None:
            for name in _PLACED:
                setattr(self, name, torch.cat([p.to(self.device, non_blocking=True)
                                               for p in getattr(self, name).pieces]))
            self._placement = None
            self._samplers = {}
        for name in _STORE:
            old = getattr(self, name)
            new = old.to(self.device)
            if new is not old:
                setattr(self, name, new)
                self._samplers = {}
        return self

    def place(self, plan) -> "FLDataset":
        """Lay the train store (``train_x``, ``train_y``, ``train_counts``)
        out over the clients axis of ``plan`` (``parallel/mesh.py:
        ShardingPlan``): each clients-axis row's contiguous clients
        (``row_ranges``) on the row's device, as a
        ``GlobalClientArray`` of one piece per row, and hand out samplers
        whose batches are laid out the same way (module docstring); in a job
        mesh only this process's rows (``process_rows``), as JAX's
        ``device_put`` onto a multi-process sharding materializes only a
        process's own shards. The test set stays whole on the primary device
        (JAX places the train arrays only). Returns self.

        On a virtual mesh (every row on the store's device) each piece is a
        view of the store, so placement costs no memory; elsewhere each
        piece is a copy of its own and the whole store is dropped. The
        samplers are dropped (JAX clears its sampler jits): a placed
        sampler is a new object, so a captured round keyed on the old one
        (``core/graphs.py``) is not reused.

        No-op cases (the first two are the JAX method's):

        - the store is already placed in this exact layout (the plan's mesh
          fingerprint and whether it is a job mesh): the sampler objects
          are kept, so a warm service or sweep process that builds one
          Simulator per request over a shared dataset makes no new sampler
          and no new captured round;
        - K is not divisible by the clients-axis width (JAX's
          ``device_put`` raises and keeps the default layout);
        - the transform has no split form (``draw`` / ``apply``
          attributes, as ``augment.cifar_train_transform`` has): a
          transform that draws from the generator over the whole batch
          cannot be applied row by row with the same draws.

        In the last two the store is left whole on the plan's primary
        device (gathered there if it was placed in another layout) and
        :attr:`place_skipped` says why; it is None after a placement."""
        k = self.num_clients
        layout = (plan.collective, plan.mesh.fingerprint())
        if layout == self._placement:
            return self
        transform = self.transform
        self.place_skipped = None
        if k % plan.clients_width:
            self.place_skipped = (f"K={k} is not divisible by the {plan.clients_width} "
                                  "clients-axis rows")
        elif transform is not None and not (hasattr(transform, "draw")
                                            and hasattr(transform, "apply")):
            self.place_skipped = (f"the transform {transform!r} has no split form "
                                  "(draw, apply)")
        self.to(plan.primary)
        if self.place_skipped is not None:
            return self
        copy = plan.collective or any(plan.row_device(r) != plan.primary
                                      for r in range(plan.clients_width))
        for name in _PLACED:
            setattr(self, name, plan.place_rows(getattr(self, name), copy=copy))
        self._placement = layout
        self._samplers = {}
        return self

    @property
    def placed(self) -> bool:
        """The train store is laid out by mesh rows (:meth:`place`)."""
        return self._placement is not None

    @property
    def sample_shape(self) -> Tuple[int, ...]:
        """One sample's shape, ``H, W, C`` for images."""
        return tuple(self.train_x.shape[2:])

    def get_clients(self) -> List:
        """Client ids (reference: ``FLDataset.get_clients``)."""
        return self.client_ids

    @property
    def test_x(self) -> torch.Tensor:
        """The union test set, normalized (by division, as the JAX
        package's eager property)."""
        x = self.test_x_raw
        return eager_normalize(self.normalize, x) if self.normalize is not None else x

    def sampler(self, local_steps: int, batch_size: int) -> Callable:
        """The round's sampler, ``generator -> (cx, cy)``: ``[K, S, B, ...]``
        train batches for every client in one gather, then the transform and
        the normalizer, torch ops on the dataset's device with no host sync
        (counterpart: ``traceable_sampler``, ``blades_tpu/datasets/fl.py:
        209-219``). ``generator`` must live on the dataset's device (the
        primary device of a placed store). One sampler is made per
        ``(local_steps, batch_size)`` and handed out again until the store
        moves (:meth:`to`) or is placed in a new layout (:meth:`place`): a
        captured round (``core/graphs.py``) keys on its identity, and it
        holds the store's tensors, so the captured gather never reads freed
        memory. A placed store's sampler returns ``GlobalClientArray``s
        laid out by its mesh rows, with the unplaced batches' bits."""
        key = (int(local_steps), int(batch_size))
        fn = self._samplers.get(key)
        if fn is not None:
            return fn
        fn = self._placed_sampler(key) if self.placed else self._whole_sampler(key)
        self._samplers[key] = fn
        return fn

    def _whole_sampler(self, key: Tuple[int, int]) -> Callable:
        train_x, train_y, counts = self.train_x, self.train_y, self.train_counts
        transform, normalize = self.transform, self.normalize
        k, n_max = train_y.shape
        need = key[0] * key[1]
        dev = train_x.device

        def sample(generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
            u = torch.rand((k, n_max), generator=generator, device=dev)
            cx, cy = _gather(u, train_x, train_y, counts, need)
            if transform is not None:
                flat = transform(cx.reshape((-1,) + cx.shape[2:]), generator)
                cx = flat.reshape(cx.shape[:2] + flat.shape[1:])
            if normalize is not None:
                cx = normalize(cx)
            cx = cx.reshape((k,) + key + tuple(cx.shape[2:]))
            return cx, cy.reshape((k,) + key)

        return sample

    def _placed_sampler(self, key: Tuple[int, int]) -> Callable:
        """The placed store's sampler (module docstring): the draws of
        :meth:`_whole_sampler` on the primary device, then per mesh row the
        gather, the transform's ``apply`` and the normalizer on the row's
        device, on the row's slice of the draws."""
        xs, ys, cs = self.train_x, self.train_y, self.train_counts
        transform, normalize = self.transform, self.normalize
        draw = None if transform is None else transform.draw
        k, n_max = int(xs.shape[0]), int(xs.shape[1])
        h, w = self.sample_shape[:2] if transform is not None else (0, 0)
        need = key[0] * key[1]
        dev0 = self.device
        rows = list(zip(xs.pieces, ys.pieces, cs.pieces, xs.starts, xs.starts[1:]))

        def sample(generator: torch.Generator):
            u = torch.rand((k, n_max), generator=generator, device=dev0)
            params = None if draw is None else draw(generator, k * need, h, w)
            px, py = [], []
            for tx, ty, tc, lo, hi in rows:
                dev = tx.device
                cx, cy = _gather(u[lo:hi].to(dev, non_blocking=True), tx, ty, tc, need)
                if params is not None:
                    mine = tree_map(lambda t: t[lo * need: hi * need].to(dev, non_blocking=True),
                                    params)
                    flat = transform.apply(cx.reshape((-1,) + cx.shape[2:]), mine)
                    cx = flat.reshape(cx.shape[:2] + flat.shape[1:])
                if normalize is not None:
                    cx = normalize(cx)
                px.append(cx.reshape((hi - lo,) + key + tuple(cx.shape[2:])))
                py.append(cy.reshape((hi - lo,) + key))
            return (GlobalClientArray(px, xs.lo, xs.hi, k),
                    GlobalClientArray(py, xs.lo, xs.hi, k))

        return sample

    def sample_round(
        self, generator: torch.Generator, local_steps: int, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[K, S, B, ...]`` train batches for every client, in one gather:
        :meth:`sampler`'s function on ``generator``, inside a scope of the
        build-provenance registry (``telemetry/programs.py``, JAX :230)."""
        with _programs.watch("dataset/sample_round",
                             shapes=(self.num_clients, int(local_steps), int(batch_size))):
            return self.sampler(local_steps, batch_size)(generator)

    def get_train_data(
        self, u_id, num_batches: int, batch_size: int = 32,
        generator: Optional[torch.Generator] = None,
    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Pull ``num_batches`` batches for one client from its persistent
        epoch stream (reference ``FLDataset.get_train_data``): a fresh
        without-replacement permutation per epoch on a host
        ``np.random.RandomState``, consumed in order, reshuffled on
        wraparound, the final batch of an epoch possibly partial. The
        stream is seeded on its first use with the client's index, or with
        a draw from ``generator`` (where the JAX package takes a key). The
        batches are normalized, not augmented, as in the JAX package."""
        i = self.client_ids.index(u_id)
        n = int(self.train_counts[i])
        train_x, train_y = self.train_x[i], self.train_y[i]  # the row, where it lies
        st = self._streams.get(i)
        if st is None:
            seed = (i if generator is None else
                    int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                      device=generator.device)))
            rs = np.random.RandomState(seed)
            st = {"rng": rs, "perm": rs.permutation(max(n, 1)), "pos": 0}
            self._streams[i] = st
        batches = []
        for _ in range(num_batches):
            if st["pos"] >= n:  # epoch over: reshuffle, restart
                st["perm"] = st["rng"].permutation(max(n, 1))
                st["pos"] = 0
            idx = torch.as_tensor(st["perm"][st["pos"]: st["pos"] + batch_size],
                                  device=train_x.device)
            st["pos"] += batch_size
            x = train_x[idx]
            if self.normalize is not None:
                x = eager_normalize(self.normalize, x)
            batches.append((x, train_y[idx]))
        return batches

    def get_all_test_data(self, u_id=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The client's own test shard, rows ``[offset, offset + count)`` of
        the union arrays, normalized; with ``u_id=None`` the whole union."""
        if u_id is None:
            return self.test_x, self.test_y
        i = self.client_ids.index(u_id)
        lo = int(self.test_offsets[i])
        hi = lo + int(self.test_counts[i])
        return self.test_x[lo:hi], self.test_y[lo:hi]

    def client_test_slices(self) -> List[np.ndarray]:
        """Index arrays into the union test set, one per client."""
        return [
            np.arange(int(o), int(o) + int(c))
            for o, c in zip(self.test_offsets, self.test_counts)
        ]

    @staticmethod
    def from_client_arrays(xs: List[np.ndarray], ys: List[np.ndarray], test_x, test_y,
                           **kwargs) -> "FLDataset":
        """Build from ragged per-client arrays by padding to ``N_max``.

        ``test_x``/``test_y`` may be union arrays or per-client lists; lists
        are concatenated and their lengths recorded as the per-client test
        shards."""
        if isinstance(test_x, (list, tuple)):
            kwargs.setdefault("test_counts", np.array([len(t) for t in test_x], np.int64))
            test_x = np.concatenate([np.asarray(t) for t in test_x])
            test_y = np.concatenate([np.asarray(t) for t in test_y])
        k = len(xs)
        counts = np.array([len(x) for x in xs], np.int32)
        n_max = int(counts.max())
        sample_shape = xs[0].shape[1:]
        train_x = np.zeros((k, n_max) + sample_shape, xs[0].dtype)
        train_y = np.zeros((k, n_max), ys[0].dtype)
        for i, (x, y) in enumerate(zip(xs, ys)):
            train_x[i, : len(x)] = x
            train_y[i, : len(y)] = y
        return FLDataset(train_x, train_y, counts, test_x, test_y, **kwargs)
