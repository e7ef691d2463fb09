"""Random-stream discipline: one ``torch.Generator`` per (seed, round,
purpose[, client]).

Counterpart: ``blades_tpu/utils/rng.py:26-61``, a ``fold_in`` key tree:

    root(seed) -> round -> purpose (DATA, AUGMENT, ATTACK, ..., DROPOUT)
                        -> CLIENTS -> client_id

and, for the streaming round's per-chunk draws (the JAX package's
``fold_in(purpose_key, chunk)``), ``round -> purpose -> CHUNKS -> chunk``.

Here every node is a fresh generator seeded from a hash of its path, so any
round's streams are a pure function of (seed, round, purpose, client) and a
round is reproducible in isolation. The bits differ from JAX's threefry
streams; tests that compare the two packages draw the random inputs once
with numpy and hand them to both.
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


def generator(
    seed: int,
    round_idx: int,
    purpose: int,
    client: Optional[int] = None,
    device="cpu",
    chunk: Optional[int] = None,
) -> torch.Generator:
    """The generator at ``root(seed) -> round -> purpose`` or, with
    ``client``, at ``root(seed) -> round -> CLIENTS -> client`` (``purpose``
    is then ignored, as the JAX tree has no purpose below a client); with
    ``chunk``, at ``... -> purpose -> CHUNKS -> chunk``."""
    path = [int(seed), int(round_idx)]
    path += [CLIENTS, int(client)] if client is not None else [int(purpose)]
    if chunk is not None:
        path += [CHUNKS, int(chunk)]
    state = np.random.SeedSequence(path).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def keep_masks(sites, generator: torch.Generator, lead=()) -> dict:
    """One boolean keep-mask per noise site (``{name: (shape, keep)}``, as a
    model's ``noise_sites`` gives them), of shape ``lead + shape``, each entry
    True with probability ``keep``, drawn in the sites' order."""
    return {
        name: torch.empty(tuple(lead) + tuple(shape), dtype=torch.bool,
                          device=generator.device).bernoulli_(keep, generator=generator)
        for name, (shape, keep) in sites.items()
    }
