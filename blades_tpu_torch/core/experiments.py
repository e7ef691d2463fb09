"""Experiment-axis batching: S independent simulations of one engine
configuration.

Counterpart: ``blades_tpu/core/experiments.py:80-315``
(``stack_experiments``, ``unstack_experiments``, ``ExperimentBatch``).
Per-experiment leaves are stacked leading-``[S]`` (``RoundState`` through
``torch.utils._pytree``); seeds and learning rates are ``[S]`` (``[R, S]``
for a block); batches are one shared ``[K, S, B, ...]`` draw or
per-experiment ``[S, K, ...]`` stacks. The results come back stacked.

``mode="map"`` runs the S experiments one after another through the
engine's round: on a graph-safe CUDA engine (``RoundEngine.
graph_block_reason``) each experiment is one replay of the engine's
captured round (``core/graphs.py``), elsewhere an eager round. Column ``s``
equals that experiment's own ``run_round`` / ``run_block`` bit for bit.

``mode="vmap"`` runs one round of the S experiments as one batched round
(``core/batched.py``, JAX ``:112-118``): local training is one
``torch.func.vmap`` over the experiment axis a client chunk, the trimmed
mean one launch of the kernel's batched entry for the S experiments, and
each experiment draws from its own generators what its own round draws.
The results equal map mode's up to the rounding of the batched
computations, as in the JAX package. On a graph-safe CUDA engine the
batched round is captured once and replayed (``core/graphs.py:
BatchRoundGraph``), elsewhere it runs eagerly; ``engine.last_block_mode``
and ``last_block_reason`` say which and why. ``run_block_batch`` is map
mode's only, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from blades_tpu_torch.core.engine import RoundSpec, block_diags
from blades_tpu_torch.utils import rng

_MODES = ("map", "vmap")


def stack_experiments(trees: List[Any]) -> Any:
    """Stack S pytrees of one structure into one leading-``[S]`` pytree.
    Tensor leaves are stacked; any other leaf (the host ``round_idx``)
    must be equal across the S trees and is kept as it is."""
    if not trees:
        raise ValueError("stack_experiments needs at least one pytree")
    flat = [tree_flatten(t) for t in trees]
    spec = flat[0][1]
    if any(s != spec for _, s in flat[1:]):
        raise ValueError("stack_experiments needs pytrees of one structure")
    leaves = []
    for column in zip(*(leaves for leaves, _ in flat)):
        if isinstance(column[0], torch.Tensor):
            leaves.append(torch.stack(column))
        elif all(v == column[0] for v in column[1:]):
            leaves.append(column[0])
        else:
            raise ValueError(f"a non-tensor leaf differs across experiments: {column}")
    return tree_unflatten(leaves, spec)


def unstack_experiments(tree: Any, num_experiments: Optional[int] = None) -> List[Any]:
    """Invert :func:`stack_experiments`: S per-experiment pytrees (views
    of the stacked tensors)."""
    leaves = [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
    if num_experiments is None:
        if not leaves:
            raise ValueError("cannot infer S from a pytree without tensors")
        num_experiments = int(leaves[0].shape[0])
    return [tree_map(lambda a: a[s] if isinstance(a, torch.Tensor) else a, tree)
            for s in range(num_experiments)]


class ExperimentBatch:
    """S independent simulations of one :class:`RoundEngine` configuration.

    The S experiments share the engine's static configuration (model, K,
    f, attack, aggregator, fault model and their Python hyperparameters);
    they differ in their states, seeds, learning rates and batches."""

    def __init__(self, engine, num_experiments: int, mode: str = "map"):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if int(num_experiments) < 1:
            raise ValueError(f"num_experiments must be >= 1, got {num_experiments}")
        self.engine = engine
        self.num_experiments = int(num_experiments)
        self.mode = mode

    def init_batch(self, params: Any) -> Any:
        """A leading-``[S]`` ``RoundState`` stack of S fresh states from one
        params template."""
        return stack_experiments([self.engine.init(params) for _ in range(self.num_experiments)])

    def _per_experiment(self, values, name: str) -> list:
        values = list(values.tolist() if isinstance(values, torch.Tensor) else values)
        if len(values) != self.num_experiments:
            raise ValueError(f"{name} has {len(values)} entries for "
                             f"{self.num_experiments} experiments")
        return values

    def run_round_batch(
        self, states: Any, cx: torch.Tensor, cy: torch.Tensor, client_lrs, server_lrs,
        seeds, shared_data: Optional[bool] = None,
    ) -> Tuple[Any, Any, Dict[str, Any]]:
        """One round of each of the S experiments. ``states``: a
        leading-``[S]`` ``RoundState`` stack; ``cx``/``cy``: one shared
        ``[K, S, B, ...]`` batch (every experiment trains on the same draw)
        or per-experiment ``[S, K, ...]`` stacks; ``shared_data`` says
        which, and is inferred from the leading size unless S == K.
        ``client_lrs`` / ``server_lrs`` / ``seeds``: ``[S]``. Returns
        ``(new_states, metrics, diags)``, each leaf leading-``[S]``."""
        eng = self.engine
        s = self.num_experiments
        if shared_data is None:
            if s == eng.num_clients:
                raise ValueError(
                    "shared_data is ambiguous when num_experiments == num_clients; pass "
                    "shared_data explicitly"
                )
            shared_data = int(cx.shape[0]) != s
        c_lrs = self._per_experiment(client_lrs, "client_lrs")
        s_lrs = self._per_experiment(server_lrs, "server_lrs")
        seeds = self._per_experiment(seeds, "seeds")
        if self.mode == "vmap":
            return self._run_vmap(states, [cx, cy], c_lrs, s_lrs, seeds, shared_data)
        outs = []
        for i, state in enumerate(unstack_experiments(states, s)):
            batch = (cx, cy) if shared_data else (cx[i], cy[i])
            spec = RoundSpec(int(seeds[i]), state.round_idx, state.round_idx,
                             float(c_lrs[i]), float(s_lrs[i]))
            outs.append(eng._run_rounds(state, [spec], batches=[batch]))
        return self._collect(outs, squeeze=True)

    def run_block_batch(
        self, states: Any, rounds, client_lrs, server_lrs, seeds,
        sampler: Optional[Callable] = None,
    ) -> Tuple[Any, Any, Dict[str, Any]]:
        """``R x S`` rounds: column ``s`` is experiment s's own
        ``run_block(state_s, rounds[:, s], client_lrs[:, s],
        server_lrs[:, s], seeds[s], sampler)``. ``rounds`` /
        ``client_lrs`` / ``server_lrs``: ``[R, S]`` (``rounds``: the rounds
        the sampler draws for); ``seeds``: ``[S]``. Returns ``(new_states,
        metrics, diags)`` with metric and counter leaves ``[R, S]``."""
        if sampler is None:
            raise ValueError("run_block_batch needs the dataset's sampler")
        if self.mode != "map":
            raise ValueError(
                "run_block_batch supports mode='map' only (the vmap schedule cannot keep "
                "the per-experiment sampler draws bit-identical to run_block's)"
            )
        eng = self.engine
        seeds = self._per_experiment(seeds, "seeds")
        col = lambda table, s: [row[s] for row in table]  # noqa: E731
        tables = [t.tolist() if isinstance(t, torch.Tensor) else t
                  for t in (rounds, client_lrs, server_lrs)]
        outs = []
        for s, state in enumerate(unstack_experiments(states, self.num_experiments)):
            specs = [RoundSpec(int(seeds[s]), state.round_idx + i, int(r), float(c), float(v))
                     for i, (r, c, v) in enumerate(zip(*(col(t, s) for t in tables)))]
            outs.append(eng._run_rounds(state, specs, sampler=sampler))
        return self._collect(outs, squeeze=False)

    @torch.no_grad()
    def _run_vmap(self, states, batch, c_lrs, s_lrs, seeds, shared_data):
        """One batched round of the S experiments (module docstring)."""
        from blades_tpu_torch.core import batched

        eng = self.engine
        eng._check_runnable()
        s = self.num_experiments
        spec = batched.batch_spec(seeds, states.round_idx, c_lrs, s_lrs)
        reason = eng.graph_block_reason()
        if reason is None:
            from blades_tpu_torch.core.graphs import run_batch_graph

            states, outs = run_batch_graph(eng, states, spec, batch, shared_data, s)
            outs = tree_map(lambda a: None if a is None else a[0], outs)
            eng.last_updates = None
        else:
            streams = rng.StreamStack(seeds, states.round_idx, eng.device)
            inputs = batched.batch_inputs(eng, c_lrs, s_lrs, states.round_idx)
            states, outs = batched.run_batched(eng, states, list(batch), inputs, streams,
                                               shared_data)
        eng.last_block_mode = "graph" if reason is None else "eager"
        eng.last_block_reason = reason
        return states, outs[0], block_diags(outs)

    def _collect(self, outs, squeeze: bool):
        """Stack the experiments' states and their ``[R]`` outputs along S
        (axis 0 for a round, axis 1 for a block's ``[R, S]``)."""
        states = stack_experiments([st for st, _ in outs])
        axis = 0 if squeeze else 1

        def stack(*xs):
            if xs[0] is None:
                return None
            xs = [x[0] for x in xs] if squeeze else xs
            return torch.stack(xs, dim=axis)

        stacked = tree_map(stack, *[o for _, o in outs])
        return states, stacked[0], block_diags(stacked)
