"""Decentralized (gossip) aggregation: mixing matrices, gossip mixing and
anchor clipping; and the asynchronous aggregators.

Counterpart: ``blades_tpu/aggregators/decentralized.py:37-336``
(``ring_adjacency``, ``torus_adjacency``, ``fully_connected_adjacency``,
``metropolis_weights``, ``DecentralizedMixing``, ``AnchorClipping``,
``Asyncmean``, ``Asynccenteredclipping``). One
gossip step for every node at once is one mixing product ``W @ U``
(``[K, K] x [K, D]``); anchor clipping folds each receiver's clip scales
into the mixing weights through the Gram identity, so nothing of size
``K^2 D`` is formed. The products are ``torch.matmul``, as the JAX package
leaves them to XLA. The mixing matrices are made on the host with numpy.

The asynchronous aggregators (JAX ``:163-336``) damp absent workers by
1/K: an absent row adds zero but stays in the denominator. Under the
buffered-asynchronous round (``blades_tpu_torch/asyncfl``) the
participation mask is the buffer's occupancy, so a fire fed by n of K
clients moves the model n/K as far. Both have exact streaming forms: a
running sum over a fixed K (centered clipping only with ``n_iter == 1``,
where the clip depends on the round-start momentum alone).
"""

from __future__ import annotations

from typing import Optional, Tuple

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


# -- asynchronous aggregators ---------------------------------------------------


class Asyncmean(Aggregator):
    """Async mean (the reference's ``_AsyncMean``): ``sum(present rows) /
    K``; without ``present`` the plain mean. Under the async round it is the
    constant-weighted FedBuff server mean with 1/K damping."""

    audit_optouts = {
        "resilience": "breakdown point 0: one unbounded byzantine row moves "
                      "the (async) average arbitrarily far",
    }
    streaming_exact = True

    def aggregate(self, updates, state=(), *, present: Optional[torch.Tensor] = None, **ctx):
        if present is None:
            return updates.mean(dim=0), state
        u = torch.where(present.to(updates.device)[:, None], updates, 0.0)
        return u.sum(dim=0) / updates.shape[0], state

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        # the participation mask is the async present mask; the masked-out
        # rows arrive zeroed, and the 1/K damping is kept
        return updates.sum(dim=0) / updates.shape[0], state

    def streaming_init(self, num_clients, num_chunks, chunk_size, dim, state=(), *,
                       device="cpu"):
        # K is the population, not the padded chunk total
        return {"sum": torch.zeros(dim, dtype=torch.float32, device=device),
                "k": torch.full((), float(num_clients), dtype=torch.float32, device=device)}

    def streaming_update(self, sstate, chunk_updates, *, chunk_mask, chunk_index, **ctx):
        w = chunk_mask.to(chunk_updates.dtype)
        return {"sum": sstate["sum"] + (chunk_updates * w[:, None]).sum(dim=0),
                "k": sstate["k"]}

    def streaming_finalize(self, sstate, state=(), **ctx):
        return sstate["sum"] / sstate["k"], state

    def __repr__(self):
        return "Asyncmean"


class Asynccenteredclipping(Aggregator):
    """Async centered clipping (the reference's ``_AsyncCenteredClipping``):
    a momentum center carried across rounds, ``n_iter`` steps ``v <- v +
    sum_present clip(u_i - v, tau) / K``."""

    stateful = True
    audit_optouts = {
        "translation": "single clipping step around the origin-anchored "
                       "momentum; the 1/K-damped under-step does not "
                       "translate with the updates",
    }

    def __init__(self, tau: float = 10.0, n_iter: int = 1):
        self.tau = float(tau)
        self.n_iter = int(n_iter)

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return torch.zeros(dim, dtype=torch.float32)

    def _clip(self, diff):
        norm = torch.linalg.vector_norm(diff, dim=1, keepdim=True)
        return diff * torch.clamp_max(self.tau / torch.clamp_min(norm, 1e-12), 1.0)

    def aggregate(self, updates, state=(), *, present: Optional[torch.Tensor] = None, **ctx):
        momentum = state.to(updates.device, updates.dtype)
        k = updates.shape[0]
        if present is None:
            present = torch.ones(k, dtype=torch.bool, device=updates.device)
        present = present.to(updates.device)
        for _ in range(self.n_iter):
            clipped = torch.where(present[:, None], self._clip(updates - momentum[None, :]), 0.0)
            momentum = momentum + clipped.sum(dim=0) / k
        return momentum, momentum

    def _masked_aggregate(self, updates, state, *, mask, **ctx):
        # the participation mask is the async present mask (1/K damping kept)
        return self.aggregate(updates, state, present=mask)

    @property
    def streaming_exact(self):  # type: ignore[override]
        return self.n_iter == 1

    def supports_streaming(self) -> bool:  # type: ignore[override]
        # the single-pass form exists only for n_iter == 1
        return self.n_iter == 1

    @property
    def streaming_optouts(self):  # type: ignore[override]
        if self.n_iter == 1:
            return {}
        return {
            "streaming": "n_iter>1 re-clips every row against a mid-pass "
                         "center; only the n_iter=1 running clipped sum "
                         "is a single-pass form",
        }

    def streaming_init(self, num_clients, num_chunks, chunk_size, dim, state=(), *,
                       device="cpu"):
        if self.n_iter != 1:
            raise NotImplementedError(self._no_streaming_msg())
        v0 = (torch.zeros(dim, dtype=torch.float32) if isinstance(state, tuple) and state == ()
              else state)
        return {"v0": v0.to(device, torch.float32),
                "clip_sum": torch.zeros(dim, dtype=torch.float32, device=device),
                "k": torch.full((), float(num_clients), dtype=torch.float32, device=device)}

    def streaming_update(self, sstate, chunk_updates, *, chunk_mask, chunk_index, **ctx):
        clipped = torch.where(chunk_mask[:, None],
                              self._clip(chunk_updates - sstate["v0"][None, :]), 0.0)
        return {"v0": sstate["v0"], "clip_sum": sstate["clip_sum"] + clipped.sum(dim=0),
                "k": sstate["k"]}

    def streaming_finalize(self, sstate, state=(), **ctx):
        momentum = sstate["v0"] + sstate["clip_sum"] / sstate["k"]
        return momentum, momentum

    def __repr__(self):
        return f"Asynccenteredclipping(tau={self.tau}, n_iter={self.n_iter})"
