"""FLDataset: the runtime federated dataset, resident on the run's device.

Counterpart: ``blades_tpu/datasets/fl.py:35-285`` (``FLDataset``;
``_make_sample_fn`` :163-207, ``traceable_sampler`` :209, ``sample_round``
:221, ``client_test_slices`` :279). All K clients' train data is one padded
``[K, N_max, ...]`` tensor family, and a round's batches for every client
come from one gather.

Sampling: each round draws, per client, a fresh without-replacement order of
its samples (uniform draws argsorted, padding pushed last) and indexes it
modulo the client's sample count (wraparound past one local epoch). A round
is a pure function of the ``torch.Generator`` it is given; the bits differ
from the JAX sampler's, so tests that compare the packages inject batches.

Not ported yet (``ROADMAP.md`` queue A, slice 4): per-sample augmentation
and normalization, the host-side ``get_train_data`` streams,
``get_all_test_data`` and ``from_client_arrays``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


class FLDataset:
    """Device-resident federated dataset.

    ``train_x``/``train_y``: per-client padded arrays ``[K, N_max, ...]`` /
    ``[K, N_max]``; ``train_counts``: ``[K]`` true sample counts (padding is
    never sampled); ``test_x``/``test_y``: the union test set ordered by
    owning client, client i owning ``test_counts[i]`` rows (default: an even
    split of the union).
    """

    def __init__(
        self,
        train_x: np.ndarray,
        train_y: np.ndarray,
        train_counts: np.ndarray,
        test_x: np.ndarray,
        test_y: np.ndarray,
        test_counts: Optional[np.ndarray] = None,
        client_ids: Optional[List] = None,
        device="cpu",
    ):
        self.device = torch.device(device)
        self.train_x = torch.as_tensor(train_x).to(self.device)
        self.train_y = torch.as_tensor(train_y).to(self.device)
        self.train_counts = torch.as_tensor(train_counts, dtype=torch.int64).to(self.device)
        self.test_x = torch.as_tensor(test_x).to(self.device)
        self.test_y = torch.as_tensor(test_y).to(self.device)
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
        self.test_offsets = np.concatenate(
            [[0], np.cumsum(self.test_counts)[:-1]]
        ).astype(np.int64)

    def to(self, device) -> "FLDataset":
        """Move the data store to ``device`` (in place; returns self). A
        store that moves drops its samplers, which hold its old tensors."""
        self.device = torch.device(device)
        for name in ("train_x", "train_y", "train_counts", "test_x", "test_y"):
            old = getattr(self, name)
            new = old.to(self.device)
            if new is not old:
                setattr(self, name, new)
                self._samplers = {}
        return self

    def get_clients(self) -> List:
        """Client ids (reference: ``FLDataset.get_clients``)."""
        return self.client_ids

    def sampler(self, local_steps: int, batch_size: int) -> Callable:
        """The round's sampler, ``generator -> (cx, cy)``: ``[K, S, B, ...]``
        train batches for every client in one gather, torch ops on the
        dataset's device with no host sync (counterpart:
        ``traceable_sampler``, ``blades_tpu/datasets/fl.py:209-219``).
        ``generator`` must live on the dataset's device. One sampler is made
        per ``(local_steps, batch_size)`` and handed out again until the
        store moves (:meth:`to`): a captured round (``core/graphs.py``)
        keys on its identity, and it holds the store's tensors, so the
        captured gather never reads freed memory."""
        key = (int(local_steps), int(batch_size))
        fn = self._samplers.get(key)
        if fn is not None:
            return fn
        train_x, train_y, counts = self.train_x, self.train_y, self.train_counts
        k, n_max = train_y.shape
        need = key[0] * key[1]
        dev = train_x.device

        def sample(generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
            u = torch.rand((k, n_max), generator=generator, device=dev)
            pad = torch.arange(n_max, device=dev)[None, :] >= counts[:, None]
            order = torch.argsort(torch.where(pad, torch.inf, u), dim=1, stable=True)
            pos = torch.arange(need, device=dev)[None, :] % torch.clamp_min(
                counts[:, None], 1
            )  # wraparound past one local epoch
            idx = torch.gather(order, 1, pos)  # [K, S*B]
            cx = train_x[torch.arange(k, device=dev)[:, None], idx]
            cy = torch.gather(train_y, 1, idx)
            cx = cx.reshape((k,) + key + tuple(cx.shape[2:]))
            return cx, cy.reshape((k,) + key)

        self._samplers[key] = sample
        return sample

    def sample_round(
        self, generator: torch.Generator, local_steps: int, batch_size: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[K, S, B, ...]`` train batches for every client, in one gather:
        :meth:`sampler`'s function on ``generator``."""
        return self.sampler(local_steps, batch_size)(generator)

    def client_test_slices(self) -> List[np.ndarray]:
        """Index arrays into the union test set, one per client."""
        return [
            np.arange(int(o), int(o) + int(c))
            for o, c in zip(self.test_offsets, self.test_counts)
        ]
