"""Dataset partitioning: IID and Dirichlet non-IID, with an on-disk cache.

Counterpart: ``blades_tpu/datasets/base.py:21-190``, ported line for line so
one seed gives the same per-client split in both packages (the partitioners
are numpy; the cache archive is the same ``.npz`` under the same name). The
store keeps the raw dtype: uint8 images stay uint8 on the device, and the
subclass's ``make_transform`` / ``make_normalize`` run in the sampler.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from blades_tpu_torch.datasets.fl import FLDataset


def partition_iid(
    x: np.ndarray, y: np.ndarray, num_clients: int, seed: int = 0
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Shuffle then equal split (reference ``train_iid``: shuffle + np.split)."""
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(x))
    xs = np.array_split(x[order], num_clients)
    ys = np.array_split(y[order], num_clients)
    return list(xs), list(ys)


def partition_dirichlet(
    x: np.ndarray,
    y: np.ndarray,
    num_clients: int,
    alpha: float = 0.1,
    seed: int = 0,
    min_size: int = 1,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-class Dirichlet(alpha) proportions over clients: for each class,
    draw p ~ Dir(alpha * 1_K) and deal that class's samples out
    proportionally. Re-draws until every client has at least ``min_size``
    samples."""
    rng = np.random.RandomState(seed)
    classes = np.unique(y)
    for _ in range(100):
        idx_per_client: List[List[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.where(y == c)[0]
            rng.shuffle(idx_c)
            p = rng.dirichlet(np.repeat(alpha, num_clients))
            cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    xs, ys = [], []
    for ix in idx_per_client:
        ix = np.asarray(ix, int)
        rng.shuffle(ix)
        xs.append(x[ix])
        ys.append(y[ix])
    return xs, ys


class BaseDataset:
    """Partitioner base: subclasses provide raw arrays via ``load_raw()``.

    Constructor surface: ``data_root``, ``train_bs`` (recorded; batching
    happens at round-sampling time), ``num_clients``, ``iid``, ``alpha``,
    ``seed``, and ``cache`` (write the partition to ``data_root`` as
    ``.npz`` and reuse it).
    """

    name: str = "base"
    num_classes: int = 10
    pad_id: Optional[int] = None  # text datasets: id of the padding token

    def __init__(
        self,
        data_root: str = "./data",
        train_bs: int = 32,
        num_clients: int = 20,
        iid: bool = True,
        alpha: float = 0.1,
        seed: int = 0,
        cache: bool = True,
    ):
        self.data_root = data_root
        self.train_bs = int(train_bs)
        self.num_clients = int(num_clients)
        self.iid = bool(iid)
        self.alpha = float(alpha)
        self.seed = int(seed)
        self.cache = bool(cache)
        self._fl: Optional[FLDataset] = None

    def load_raw(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Return (train_x, train_y, test_x, test_y) as numpy arrays."""
        raise NotImplementedError

    def make_transform(self) -> Optional[Callable]:
        """Batched train augmentation ``(x [N, ...], generator) -> x``, run
        in the sampler, or None."""
        return None

    def make_normalize(self) -> Optional[Callable]:
        """Cast and standardization ``(x) -> x`` on the device, or None."""
        return None

    def _cache_path(self) -> str:
        meta = f"{self.name}-v2-{self.num_clients}-{self.iid}-{self.alpha}-{self.seed}"
        h = hashlib.md5(meta.encode()).hexdigest()[:10]
        return os.path.join(self.data_root, f"{self.name}_part_{h}.npz")

    def _partition(self):
        path = self._cache_path()
        if self.cache and os.path.exists(path):
            z = np.load(path, allow_pickle=False)
            return (
                z["train_x"],
                z["train_y"],
                z["train_counts"],
                z["test_x"],
                z["test_y"],
                z["test_counts"],
            )
        train_x, train_y, test_x, test_y = self.load_raw()
        # per-client test shards: shuffle the union then deal evenly
        t_order = np.random.RandomState(self.seed).permutation(len(test_y))
        test_x, test_y = test_x[t_order], test_y[t_order]
        test_counts = np.array(
            [len(s) for s in np.array_split(np.arange(len(test_y)), self.num_clients)],
            np.int64,
        )
        if self.iid:
            xs, ys = partition_iid(train_x, train_y, self.num_clients, self.seed)
        else:
            xs, ys = partition_dirichlet(
                train_x, train_y, self.num_clients, self.alpha, self.seed
            )
        counts = np.array([len(a) for a in xs], np.int32)
        n_max = int(counts.max())
        px = np.zeros((self.num_clients, n_max) + train_x.shape[1:], train_x.dtype)
        py = np.zeros((self.num_clients, n_max), train_y.dtype)
        for i, (a, b) in enumerate(zip(xs, ys)):
            px[i, : len(a)] = a
            py[i, : len(b)] = b
        if self.cache:
            os.makedirs(self.data_root, exist_ok=True)
            np.savez_compressed(
                path,
                train_x=px,
                train_y=py,
                train_counts=counts,
                test_x=test_x,
                test_y=test_y,
                test_counts=test_counts,
            )
        return px, py, counts, test_x, test_y, test_counts

    def get_dls(self, device="cpu") -> FLDataset:
        """Build (or return the cached) runtime :class:`FLDataset` on
        ``device``. Name kept for reference parity."""
        if self._fl is None:
            px, py, counts, test_x, test_y, test_counts = self._partition()
            self._fl = FLDataset(
                px, py, counts, test_x, test_y,
                transform=self.make_transform(),
                normalize=self.make_normalize(),
                pad_id=self.pad_id,
                test_counts=test_counts,
                device=device,
            )
        elif self._fl.device != torch.device(device):
            self._fl.to(device)
        return self._fl
