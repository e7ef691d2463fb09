"""The batched round of ``ExperimentBatch(mode="vmap")``: S experiments of
one engine configuration as one round.

Counterpart: ``blades_tpu/core/experiments.py:112-118``, ``jax.vmap`` of
the engine's round over the experiment axis (``in_axes=(0, d_ax, d_ax, 0,
0, 0)``: the states, the batch unless it is shared, the learning rates and
the keys). JAX batches every step of the round; the port batches the steps
that carry the work and runs the others per experiment, inside the same
call:

- each experiment runs its own round body (``RoundEngine._round_body``, a
  generator) with its own generators (``utils/rng.py:StreamStack``), so it
  draws exactly what its own round draws: the keep-masks, the noise
  attack's normals, DnC's subspaces, the fault and arrival draws. The S
  bodies run in lockstep, and where they yield a request, the request is
  served once for all S (:func:`_serve_batched`):
- ``"train"``: local training, ``torch.func.vmap`` over the experiment
  axis around the engine's per-chunk step (``RoundEngine._train_chunk``,
  itself ``vmap(grad_and_value(...))`` over the chunk's clients): one
  call a chunk for the S experiments, the params, optimizer state,
  learning rates, keep-masks and start params batched, the data batched
  (``[S, K, ...]``) or shared (``[K, ...]``, ``in_dims=None``);
- ``"attack"``: ``Attack.on_updates_batched`` (ALIE in one vmapped call;
  an attack that draws, per experiment from its own generator);
- ``"aggregate"``: ``Aggregator.aggregate_masked_batched`` (mean, median
  and trimmed mean in one batched call, the trimmed mean ONE launch of the
  kernel's batched entry; every other defense, and every masked form, per
  experiment on row s: GeoMed's and AutoGM's host stopping tests, the
  clustering linkage and Krum's selection branch on each experiment's
  data);
- ``"server"``: the server step, ``torch.func.vmap`` over the experiments.

Everything between the requests (``nan_to_num``, the fault model, the
streaming folds, the async buffer, the audit monitor, the metric pack and
the round's metrics) runs per experiment, as its own round runs it. The
results equal each experiment's own round up to the rounding of the
batched computations (the JAX package's vmap mode is not bit-identical to
its map mode either).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch.func import vmap
from torch.utils._pytree import tree_map

from blades_tpu_torch.core.engine import RoundInputs, RoundSpec
from blades_tpu_torch.utils import rng


class BatchSpec(NamedTuple):
    """One batched round: each experiment's :class:`RoundSpec` (one host
    round index for all, as the stacked state holds one)."""

    specs: tuple

    @property
    def round_idx(self) -> int:
        return self.specs[0].round_idx


def batch_inputs(engine, client_lrs, server_lrs, round_idx: int) -> RoundInputs:
    """The batched round's inputs on the engine's device: ``[S]`` learning
    rates and the shared 0-d round index."""
    dev = engine.device
    return RoundInputs(torch.tensor(client_lrs, dtype=torch.float32).to(dev),
                       torch.tensor(server_lrs, dtype=torch.float32).to(dev),
                       torch.full((), int(round_idx), dtype=torch.int64, device=dev))


def stack_trees(trees: list):
    """S pytrees of one structure, tensor leaves stacked on a new axis 0;
    a non-tensor leaf (the host ``round_idx``) is taken from the first."""
    return tree_map(lambda *xs: _stack_rows(xs) if isinstance(xs[0], torch.Tensor) else xs[0],
                    *trees)


def _rows(tree, s: int):
    return tree_map(lambda t: t[s] if isinstance(t, torch.Tensor) else t, tree)


def _stack_rows(ts) -> torch.Tensor:
    """``torch.stack(ts)``, or without a copy the tensor whose rows ``ts``
    are (each ``ts[s]`` is ``base[s]``, as a batched step hands them out)."""
    base = ts[0]._base
    if (base is not None and base.is_contiguous() and base.dim() == ts[0].dim() + 1
            and base.shape[0] == len(ts) and base.dtype == ts[0].dtype):
        row = base[0]
        if all(t._base is base and t.shape == row.shape and t.stride() == row.stride()
               and t.data_ptr() == base[i].data_ptr() for i, t in enumerate(ts)):
            return base
    return torch.stack(list(ts))


#: the engine's per-round surfaces, in :meth:`RoundEngine.round_outputs`
#: order after the metrics, then the received matrix
_SURFACES = ("last_diagnostics", "last_fault_diag", "last_audit_diag", "last_metric_pack",
             "last_async_diag", "last_updates")
_UNSET = object()


def run_batched(engine, states, batch: list, inputs: RoundInputs,
                streams: rng.StreamStack, shared: bool):
    """One batched round of S experiments (module docstring). ``states``: a
    leading-``[S]`` ``RoundState`` stack; ``batch``: ``[cx, cy]``, shared
    ``[K, steps, B, ...]`` or per experiment ``[S, K, steps, B, ...]``,
    emptied once training has consumed it; ``inputs``: from
    :func:`batch_inputs`. Returns ``(new states, outputs)``: the stacked
    state and each experiment's :meth:`RoundEngine.round_outputs` stacked
    ``[S]`` (None where a surface is off). ``engine.last_updates`` is the
    ``[S, K, D]`` stack of the received matrices under ``keep_updates``."""
    n = len(streams)
    lead = 0 if shared else 1
    steps_batch = (batch[0].shape[1 + lead], batch[0].shape[2 + lead])
    bodies = [
        engine._round_body(_rows(states, s),
                           RoundInputs(inputs.client_lr[s], inputs.server_lr[s], inputs.round_t),
                           streams[s], steps_batch)
        for s in range(n)
    ]
    results: List = [None] * n
    # a body sets the engine's last_* surfaces in one of its segments: what
    # a segment sets is taken before the next body's segment runs
    surfaces = [[None] * len(_SURFACES) for _ in range(n)]
    replies = [None] * n
    while True:
        reqs = []
        for s, body in enumerate(bodies):
            for name in _SURFACES:
                setattr(engine, name, _UNSET)
            box, replies[s] = (None if replies[s] is None else [replies[s]]), None
            try:
                reqs.append(body.send(box))
            except StopIteration as stop:
                results[s] = stop.value
            for i, name in enumerate(_SURFACES):
                value = getattr(engine, name)
                if value is not _UNSET:
                    surfaces[s][i] = value
                setattr(engine, name, surfaces[s][i])
        if len(reqs) != (0 if results[0] is not None else n):
            raise RuntimeError("the experiments' round bodies went out of step")
        if not reqs:
            break
        kinds = {kind for kind, _ in reqs}
        if len(kinds) != 1:
            raise RuntimeError(f"the experiments' round bodies went out of step: {kinds}")
        replies = _serve_batched(engine, kinds.pop(), [req for _, req in reqs], batch, shared)
        del reqs  # the bodies alone hold what they handed over
    stack = lambda *xs: None if xs[0] is None else torch.stack(xs)  # noqa: E731
    outs = [(metrics, *surf[:5]) for (_, metrics), surf in zip(results, surfaces)]
    engine.last_updates = None if surfaces[0][5] is None else torch.stack(
        [surf[5] for surf in surfaces])
    return stack_trees([st for st, _ in results]), tree_map(stack, *outs)


def _serve_batched(engine, kind: str, reqs: list, batch: list, shared: bool) -> list:
    """The answers to S experiments' requests of one kind, one batched call
    (module docstring); the list of each experiment's answer."""
    n = len(reqs)
    if kind == "train":
        return _train_batched(engine, reqs, batch, shared)
    if kind == "attack":
        updates, new_states = engine.attack.on_updates_batched(
            _stack_rows([r[0] for r in reqs]), reqs[0][1], [r[2] for r in reqs],
            [r[3] for r in reqs])
        return [(updates[s], new_states[s]) for s in range(n)]
    if kind == "aggregate":
        masks = None if reqs[0][2] is None else torch.stack([r[2] for r in reqs])
        agg, new_states, diags = engine.aggregator.aggregate_masked_batched(
            _stack_rows([r[0] for r in reqs]), [r[1] for r in reqs], masks=masks,
            ctxs=[r[3] for r in reqs], diagnostics=engine.collect_diagnostics)
        return [(agg[s], new_states[s], None if diags is None else diags[s]) for s in range(n)]
    if kind == "server":
        params, opt_state = vmap(engine._server_step)(*(stack_trees([r[i] for r in reqs])
                                                         for i in range(4)))
        return [(_rows(params, s), _rows(opt_state, s)) for s in range(n)]
    raise ValueError(f"unknown round request {kind!r}")


def _train_batched(engine, reqs: list, batch: list, shared: bool) -> list:
    """S experiments' local training, one ``torch.func.vmap`` call over the
    experiment axis a chunk (all chunks, or the one chunk of a streaming
    request); the batch is dropped once the last chunk has trained."""
    first, n = reqs[0], len(reqs)
    params = stack_trees([r.params for r in reqs])
    flat0 = _stack_rows([r.flat0 for r in reqs])
    lrs = torch.stack([r.client_lr for r in reqs])
    opt = stack_trees([r.opt_state for r in reqs])
    # each experiment's own masks, drawn by its own body, stacked [S, K, ...]
    noise = [{name: torch.stack([r.noise[i][name] for r in reqs]) for name in masks}
             for i, masks in enumerate(first.noise)]
    lag = None if first.lag is None else tuple(
        torch.stack([r.lag[j] for r in reqs]) for j in range(2))
    data_dim = None if shared else 0
    cx, cy = batch

    def chunk(rows, opt_rows):
        def step(p, f0, lr, x, y, masks, o, lg):
            start = None if lg is None else lg[0][lg[1][rows]]
            return engine._train_chunk(p, f0, lr, x, y, rows, masks, o, start)

        return vmap(step, in_dims=(0, 0, 0, data_dim, data_dim, 0, 0,
                                   None if lag is None else 0))(
            params, flat0, lrs, cx, cy, noise, opt_rows, lag)

    if first.rows is None:
        out = [chunk(rows, tree_map(lambda t: t[:, rows], opt))
               for rows in engine._chunk_rows()]
        updates, losses, top1s = (torch.cat(parts, 1) for parts in list(zip(*out))[:3])
        new_opt = engine._cat_opt_states([o[3] for o in out], dim=1)
        last = True
    else:
        updates, losses, top1s, new_opt = chunk(first.rows, opt)
        last = first.last
    del cx, cy
    if last:
        batch.clear()
    return [(updates[s], losses[s], top1s[s], _rows(new_opt, s)) for s in range(n)]


def batch_spec(seeds, round_idx: int, client_lrs, server_lrs) -> BatchSpec:
    """The :class:`BatchSpec` of one batched round at host round ``round_idx``."""
    return BatchSpec(tuple(RoundSpec(int(sd), int(round_idx), int(round_idx), float(c), float(v))
                           for sd, c, v in zip(seeds, client_lrs, server_lrs)))
