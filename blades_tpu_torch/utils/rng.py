"""Random-stream discipline: one ``torch.Generator`` per (seed, round,
purpose[, client]).

Counterpart: ``blades_tpu/utils/rng.py:26-61``, a ``fold_in`` key tree:

    root(seed) -> round -> purpose (DATA, AUGMENT, ATTACK, ..., DROPOUT)
                        -> CLIENTS -> client_id

and, for the streaming round's per-chunk draws (the JAX package's
``fold_in(purpose_key, chunk)``), ``round -> purpose -> CHUNKS -> chunk``.

Here every node is a generator seeded from a hash of its path
(:func:`seed_of`), so any round's streams are a pure function of (seed,
round, purpose, client) and a round is reproducible in isolation; a round
takes its generators from a :class:`RoundStreams`. The bits differ from
JAX's threefry streams; tests that compare the two packages draw the random
inputs once with numpy and hand them to both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# Purpose tags; keep stable across releases for reproducibility.
DATA = 0
AUGMENT = 1
ATTACK = 2
INIT = 3
EVAL = 4
# client streams branch through a dedicated tag first, so a client id can
# never collide with a purpose stream
CLIENTS = 5
AGG = 6
FAULT = 7
ARRIVAL = 8
# local training's dropout and DropPath masks (the JAX package folds the
# client's step key instead: ``blades_tpu/core/engine.py:580``)
DROPOUT = 9
# a purpose stream's per-chunk children (the streaming round's attack and
# bit-flip draws); the tag is nonzero, so a chunk stream never shares its
# path with its parent
CHUNKS = 10


def seed_of(
    seed: int,
    round_idx: int,
    purpose: int,
    client: Optional[int] = None,
    chunk: Optional[int] = None,
) -> int:
    """The seed of the node at ``root(seed) -> round -> purpose`` or, with
    ``client``, at ``root(seed) -> round -> CLIENTS -> client`` (``purpose``
    is then ignored, as the JAX tree has no purpose below a client); with
    ``chunk``, at ``... -> purpose -> CHUNKS -> chunk``."""
    path = [int(seed), int(round_idx)]
    path += [CLIENTS, int(client)] if client is not None else [int(purpose)]
    if chunk is not None:
        path += [CHUNKS, int(chunk)]
    state = np.random.SeedSequence(path).generate_state(1, np.uint64)[0]
    return int(state) >> 1


def generator(
    seed: int,
    round_idx: int,
    purpose: int,
    client: Optional[int] = None,
    device="cpu",
    chunk: Optional[int] = None,
) -> torch.Generator:
    """A new generator seeded at :func:`seed_of`'s node."""
    return torch.Generator(device=device).manual_seed(
        seed_of(seed, round_idx, purpose, client=client, chunk=chunk))


def clone(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A new generator at ``generator``'s current state (None stays None):
    two calls that each get a clone draw the same numbers."""
    if generator is None:
        return None
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


class RoundStreams:
    """A round's generators, one per ``(purpose, chunk, copy)``, made on
    first request and handed out again on a later one.

    A new instance per round gives the generators :func:`generator` makes.
    A captured round (``core/graphs.py``) keeps one instance and calls
    :meth:`reseed` before each replay: ``manual_seed`` puts a generator at
    its node with the Philox offset at 0, the state a new one starts from,
    so a replayed round draws the bits an eager round draws. ``DATA`` is
    rooted at ``data_round``, the round the sampler draws for (the
    Simulator counts those from 1), every other purpose at ``round_idx``.
    """

    def __init__(self, seed: int, round_idx: int, device="cpu",
                 data_round: Optional[int] = None):
        self.device = torch.device(device)
        self._held = {}
        self._at(seed, round_idx, data_round)

    def _at(self, seed, round_idx, data_round):
        self.seed, self.round_idx = int(seed), int(round_idx)
        self.data_round = self.round_idx if data_round is None else int(data_round)

    def _seed(self, purpose: int, chunk: Optional[int]) -> int:
        r = self.data_round if purpose == DATA else self.round_idx
        return seed_of(self.seed, r, purpose, chunk=chunk)

    def __call__(self, purpose: int, chunk: Optional[int] = None,
                 copy: int = 0) -> torch.Generator:
        """The held generator of ``(purpose, chunk)``. ``copy`` > 0 holds
        another generator at the same node, which draws from the node's
        entry state whatever the first one has drawn: where the JAX package
        hands one key to two consumers (the defense and the audit's
        fallback), each gets its own copy."""
        key = (int(purpose), None if chunk is None else int(chunk), int(copy))
        gen = self._held.get(key)
        if gen is None:
            gen = self._held[key] = torch.Generator(device=self.device).manual_seed(
                self._seed(*key[:2]))
        return gen

    def reseed(self, seed: int, round_idx: int, data_round: Optional[int] = None) -> None:
        """Move every held generator to its node of another round."""
        self._at(seed, round_idx, data_round)
        for key, gen in self._held.items():
            gen.manual_seed(self._seed(*key[:2]))

    def generators(self) -> list:
        return list(self._held.values())


class StreamStack:
    """S experiments' :class:`RoundStreams`, one per experiment seed, for
    the batched round of ``ExperimentBatch(mode="vmap")``: experiment ``s``
    draws from its own generators exactly what its own round draws, and the
    draws are stacked on a leading ``[S]`` axis only after they are made
    (``torch.func.vmap(randomness="different")`` would draw from one shared
    generator instead)."""

    def __init__(self, seeds, round_idx: int, device="cpu",
                 data_round: Optional[int] = None):
        self.streams = [RoundStreams(s, round_idx, device, data_round=data_round)
                        for s in seeds]

    def __len__(self) -> int:
        return len(self.streams)

    def __getitem__(self, s: int) -> RoundStreams:
        return self.streams[s]

    def reseed(self, seeds, round_idx: int, data_round: Optional[int] = None) -> None:
        for st, seed in zip(self.streams, seeds):
            st.reseed(seed, round_idx, data_round)

    def generators(self) -> list:
        return [g for st in self.streams for g in st.generators()]


def keep_masks(sites, generator: torch.Generator, lead=()) -> dict:
    """One boolean keep-mask per noise site (``{name: (shape, keep)}``, as a
    model's ``noise_sites`` gives them), of shape ``lead + shape``, each entry
    True with probability ``keep``, drawn in the sites' order."""
    return {
        name: torch.empty(tuple(lead) + tuple(shape), dtype=torch.bool,
                          device=generator.device).bernoulli_(keep, generator=generator)
        for name, (shape, keep) in sites.items()
    }
