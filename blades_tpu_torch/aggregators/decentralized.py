"""Decentralized (gossip) aggregation: mixing matrices, gossip mixing and
anchor clipping.

Counterpart: ``blades_tpu/aggregators/decentralized.py:37-160``
(``ring_adjacency``, ``torus_adjacency``, ``fully_connected_adjacency``,
``metropolis_weights``, ``DecentralizedMixing``, ``AnchorClipping``). One
gossip step for every node at once is one mixing product ``W @ U``
(``[K, K] x [K, D]``); anchor clipping folds each receiver's clip scales
into the mixing weights through the Gram identity, so nothing of size
``K^2 D`` is formed. The products are ``torch.matmul``, as the JAX package
leaves them to XLA. The mixing matrices are made on the host with numpy.

The asynchronous aggregators of the same JAX module (``Asyncmean``,
``Asynccenteredclipping``) come with ``ROADMAP.md`` queue A, slice 9; the
registry names them as unported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from blades_tpu_torch.aggregators.base import Aggregator


# -- mixing matrices (host-side, numpy) ----------------------------------------


def ring_adjacency(k: int) -> np.ndarray:
    """Ring topology: node i <-> i +- 1 (mod k)."""
    a = np.zeros((k, k), bool)
    idx = np.arange(k)
    a[idx, (idx + 1) % k] = True
    a[idx, (idx - 1) % k] = True
    np.fill_diagonal(a, False)
    return a


def torus_adjacency(rows: int, cols: int) -> np.ndarray:
    """2-D torus: node (r, c) <-> its 4 wrap-around grid neighbours."""
    k = rows * cols
    a = np.zeros((k, k), bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                j = (rr % rows) * cols + (cc % cols)
                if j != i:
                    a[i, j] = True
    return a


def fully_connected_adjacency(k: int) -> np.ndarray:
    a = np.ones((k, k), bool)
    np.fill_diagonal(a, False)
    return a


def metropolis_weights(adjacency: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings mixing matrix: symmetric and doubly stochastic
    for any undirected graph; ``W[i, j] = 1 / (1 + max(deg_i, deg_j))`` on
    edges, the rest of each row's mass on the diagonal."""
    adj = np.asarray(adjacency, bool)
    if not (adj == adj.T).all():
        raise ValueError("adjacency must be symmetric (undirected graph)")
    deg = adj.sum(axis=1)
    w = np.where(adj, 1.0 / (1.0 + np.maximum(deg[:, None], deg[None, :])), 0.0)
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


# -- decentralized aggregators ------------------------------------------------


class DecentralizedMixing(Aggregator):
    """One gossip round for every node at once: ``mix(updates) = W @
    updates``, each node's own mixture (``[K, D]``). ``aggregate`` returns
    the row mean of the mixture, so the class also serves as a server
    aggregator."""

    def __init__(self, weights: np.ndarray):
        self.weights = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
        self._on_device = self.weights

    def _w(self, like: torch.Tensor) -> torch.Tensor:
        """The mixing matrix on ``like``'s device and dtype, copied there
        once and kept, so later rounds make no host-to-device copy."""
        if (self._on_device.device, self._on_device.dtype) != (like.device, like.dtype):
            self._on_device = self.weights.to(like.device, like.dtype)
        return self._on_device

    def mix(self, updates: torch.Tensor) -> torch.Tensor:
        return self._w(updates) @ updates

    def aggregate(self, updates, state=(), **ctx):
        return self.mix(updates).mean(dim=0), state

    def __repr__(self):
        return f"DecentralizedMixing(K={self.weights.shape[0]})"


class AnchorClipping(DecentralizedMixing):
    """Gossip centered clipping: each incoming update is pulled toward the
    receiving node's anchor by a clipped difference, then mixed,
    ``mixed[r] = sum_s W[r, s] (a_r + (u_s - a_r) S[r, s])`` with
    ``S[r, s] = min(1, tau / |u_s - a_r|)``; the anchors accumulate each
    node's mixed result. State: anchors ``[K, D]``."""

    stateful = True

    def __init__(self, weights: np.ndarray, tau: float = 10.0):
        super().__init__(weights)
        self.tau = float(tau)

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return torch.zeros(num_clients, dim, dtype=torch.float32)

    def mix_with_state(
        self, updates: torch.Tensor, anchors: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(mixed [K, D], new anchors [K, D])``. ``|u_s - a_r|^2`` comes
        from the Gram identity (one ``[K, K]`` product), and
        ``mixed = a * (rowsum(W) - rowsum(W S)) + (W S) @ U``."""
        anchors = anchors.to(updates.device, updates.dtype)
        w = self._w(updates)
        sq = torch.clamp_min(
            (updates * updates).sum(dim=1)[None, :]
            - 2.0 * anchors @ updates.T
            + (anchors * anchors).sum(dim=1)[:, None],
            0.0,
        )  # [receiver, sender]
        ws = w * torch.clamp_max(self.tau / torch.clamp_min(torch.sqrt(sq), 1e-12), 1.0)
        coeff = w.sum(dim=1) - ws.sum(dim=1)
        mixed = coeff[:, None] * anchors + ws @ updates
        return mixed, anchors + mixed

    def aggregate(self, updates, state=(), **ctx):
        mixed, anchors = self.mix_with_state(updates, state)
        return mixed.mean(dim=0), anchors

    def __repr__(self):
        return f"AnchorClipping(tau={self.tau})"
