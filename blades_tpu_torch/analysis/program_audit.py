"""Tier B: structural invariants on the port's round programs.

Counterpart: ``blades_tpu/analysis/program_audit.py`` (``run_tier_b``
:329, ``_build_engine`` :52). The Tier-A lints catch source patterns; this
auditor runs the port's real programs at the JAX auditor's toy
configuration (``_K, _STEPS, _BATCH = 8, 1, 2``, the MLP with one hidden
layer of 8, sign flipping f=2 plus the trimmed mean, whose b=3 takes the
kernel route) on a caller-given device, and checks, per program:

- **storage**, the counterpart of donation. Where the JAX engine donates
  its state, the port's captured round keeps it in static buffers and
  writes each round's new state back into them (``core/graphs.py:_storage``
  :94, ``write_back`` :98): for a block that ran as a graph, every tensor
  of the graph's state keeps its ``untyped_storage().data_ptr()`` from one
  block to the next, and holds the state the block returned. Eagerly the
  port donates nothing but the batch: ``run_round_donated`` empties the
  batch list once local training consumed it, and the round writes none
  of the caller's state (``RoundEngine._init``'s private copy: a caller
  that keeps the old state keeps it intact). So for every program the
  caller's state keeps each tensor leaf (same object, storage and
  ``_version``), and where the program takes a batch list it is empty
  after the call.
- **dtype**, the counterpart of "no f64". No op of the program's first
  call makes a float64 (or complex128) tensor, observed with a
  ``TorchDispatchMode`` around the call. A graph block's first call is its
  eager warm-up round and its capture (``core/graphs.py:RoundGraph.run``):
  the mode sees both, and no replay (which runs no Python). The window is
  the engine's call: ``core/engine.py:outputs_to_host`` packs a round's
  outputs as one float64 vector on the device for a single host read
  (:1178), the counterpart of the JAX host's conversion of the round's
  float32 outputs, which the JAX auditor's compiled program leaves out too;
  the check runs that pack on the call's outputs outside the window and
  reports its float64 tensors in ``detail``, never as a failure.
- **sharding axis**, the counterpart of the JAX check (:194-225,
  :313-326, :370-371) that no sharding constraint partitions the fresh
  ``[K, D]`` matrix along the model axis, the reshard under which XLA once
  miscompiled every row into ``update + params``. The port places its
  round itself (``parallel/mesh.py``), so the check tests that failure
  directly: the program runs once more on an engine with a sharding plan
  over a virtual ``(2, 4)`` mesh of the device (``_MESH_SHAPE``: the
  clients axis cuts each chunk in two, the trimmed mean runs in 4 column
  blocks), from the same state, on the same batches laid out by the mesh's
  clients-axis rows as a placed store's sampler lays them out
  (``ShardingPlan.place_rows``, ``datasets/fl.py:FLDataset.place``), and
  the post-attack ``[K, D]`` rows (where the program keeps them) and the
  new params must equal the first call's, at the JAX test's tolerances
  (``tests/test_engine.py:242-252``).
- **rebuild stability**, the counterpart of retrace stability. The
  program's engine comes from an
  :class:`~blades_tpu_torch.sweeps.EngineCache` keyed as ``Simulator.run``
  keys it (``sweeps.program_fingerprint``). A second same-shape call adds
  zero to ``telemetry/recorder.py:process_counters()``
  (``cuda.graph_captures``, ``cuda.kernel_builds``, ``cuda.kernel_reuses``:
  captures, kernel builds and library loads), emits no ``program`` record
  with a build outcome (``telemetry/programs.py``), and does not grow the
  cache. On the CPU no program captures or builds, so this form proves
  less; the card's form carries the rest.

The report keeps the JAX shape: ``{"checks": [{"check", "program", "ok",
"detail"}], "violations", "ok", "programs"}``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from blades_tpu_torch.core.graphs import _storage

#: Toy config: production program shape, seconds-scale runs.
_K, _STEPS, _BATCH = 8, 1, 2
_BLOCK_ROUNDS = 2
_CHUNKS = 2
_S = 2

#: the programs of :func:`run_tier_b`, in its order
PROGRAMS = ("round", "block", "streaming", "experiment_batch_map",
            "experiment_batch_vmap", "async")
#: the sharding check's virtual mesh: (clients, model) entries of the device
_MESH_SHAPE = (2, 4)
#: the sharding check's tolerances (JAX ``tests/test_engine.py:242-252``)
_ROWS_TOL = dict(rtol=1e-4, atol=1e-6)
_PARAMS_TOL = dict(rtol=1e-5, atol=1e-7)

#: the checks of every program
CHECKS = ("storage", "dtype", "sharding_axis", "rebuild_stability")

#: the process counters a second same-shape call must leave alone
REBUILD_COUNTERS = ("cuda.graph_captures", "cuda.kernel_builds", "cuda.kernel_reuses")

_WIDE = (torch.float64, torch.complex128)


def _result(check: str, program: str, ok, detail: str) -> Dict[str, Any]:
    return {"check": check, "program": program, "ok": ok if ok is None else bool(ok),
            "detail": detail}


# -- building the toy programs ---------------------------------------------------


def _parts(streaming: bool = False, client_chunks: int = 1, use_async: bool = False,
           plan=None) -> dict:
    """A fresh configuration of the toy engine (new attack, defense and
    option objects each call, as a new ``Simulator.run`` makes them)."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.asyncfl import ArrivalProcess, AsyncConfig
    from blades_tpu_torch.attackers import get_attack
    from blades_tpu_torch.core import ClientOptSpec, ServerOptSpec

    async_config = None
    if use_async:
        async_config = AsyncConfig(
            buffer_m=_K // 2,
            arrivals=ArrivalProcess(kind="uniform", max_delay=1),
            staleness="polynomial",
            alpha=0.5,
        )
    return dict(attack=get_attack("signflipping"), aggregator=get_aggregator("trimmedmean"),
                client_opt=ClientOptSpec(), server_opt=ServerOptSpec(), streaming=streaming,
                client_chunks=client_chunks, async_config=async_config, plan=plan)


def engine_key(engine_cls=None, **kw) -> str:
    """The toy engine's ``EngineCache`` key: ``sweeps.program_fingerprint``
    of a fresh configuration, as ``Simulator.run`` keys its engines."""
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.sweeps import program_fingerprint

    parts = _parts(**kw)
    plan = parts.pop("plan")
    return program_fingerprint(model="mlp-8", clients=_K, byzantine=2,
                               engine=(engine_cls or RoundEngine).__qualname__,
                               plan=None if plan is None else plan.mesh.fingerprint(), **parts)


def build_engine(device, engine_cls=None, **kw):
    """A tiny-MLP ``RoundEngine`` wired like the JAX auditor's (trimmed
    mean, sign flipping f=2); ``use_async=True`` builds the buffered-async
    tick (a lagging uniform arrival process, polynomial staleness).
    ``engine_cls``: a ``RoundEngine`` subclass in its place. Returns
    ``(engine, params)``."""
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.models.common import build_fns
    from blades_tpu_torch.models.mlp import MLP

    spec = build_fns(MLP(28 * 28, 10, hidden=(8,)))
    params = spec.init(torch.Generator().manual_seed(0))
    engine = (engine_cls or RoundEngine)(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
        num_clients=_K, num_byzantine=2, num_classes=10, keep_updates=True,
        device=device, noise_sites=spec.noise_sites, **_parts(**kw),
    )
    return engine, params


def toy_batch(device) -> list:
    """A ``[K, steps, B, 28, 28, 1]`` batch and its labels, as a list a
    round may empty."""
    g = torch.Generator().manual_seed(7)
    shape = (_K, _STEPS, _BATCH)
    cx = torch.randn(shape + (28, 28, 1), generator=g)
    cy = torch.randint(0, 10, shape, generator=g, dtype=torch.int32)
    return [cx.to(device), cy.to(device)]


def toy_sampler(device) -> Callable:
    """A batch source ``generator -> (cx, cy)`` drawn on ``device`` (the
    production sampler is likewise a function of the round's generator);
    one object, so a graph keyed on it is reused."""

    def sampler(gen):
        cx = torch.randn((_K, _STEPS, _BATCH, 28, 28, 1), generator=gen, device=device)
        cy = torch.randint(0, 10, (_K, _STEPS, _BATCH), generator=gen, device=device,
                           dtype=torch.int32)
        return cx, cy

    return sampler


def place_batch(engine, batch) -> list:
    """``batch`` laid out by the clients-axis rows of ``engine``'s plan, as
    a placed store's sampler returns it (``GlobalClientArray``s); the batch
    itself for an engine without a plan."""
    plan = engine.plan
    return list(batch) if plan is None else [plan.place_rows(t) for t in batch]


# -- the invariants ------------------------------------------------------------------


class DtypeWatch(TorchDispatchMode):
    """Every op dispatched while active: the count, and the ops whose
    outputs are float64 or complex128."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.wide: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.dtype in _WIDE:
                self.wide.append(f"{func}->{t.dtype}")
        return out


def _leaves(tree, path: str = "state") -> list:
    """``(path, tensor)`` of every tensor leaf of a state (dicts, named
    tuples, tuples and lists)."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for k in tree._fields for x in _leaves(getattr(tree, k), f"{path}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]
    return []


def storage_snapshot(tree) -> Dict[str, tuple]:
    """Each tensor leaf's ``(object id, storage pointer, version)``."""
    return {p: (id(t), _storage(t), t._version) for p, t in _leaves(tree)}


def check_dtype(program: str, watch: DtypeWatch, outputs=None) -> Dict[str, Any]:
    """No op of the watched window made a float64 tensor. ``outputs``: the
    call's round outputs, whose host pack (``outputs_to_host``, outside the
    window) is counted for ``detail`` only."""
    note = ""
    if outputs is not None:
        from blades_tpu_torch.core.engine import outputs_to_host

        pack = DtypeWatch()
        with pack:
            outputs_to_host(outputs)
        note = (f"; outside the window, outputs_to_host's host pack made "
                f"{len(pack.wide)} float64 tensor(s) in {pack.ops} ops")
    ok = not watch.wide
    detail = (f"no float64 in {watch.ops} ops of the first call" if ok else
              f"{len(watch.wide)} float64 outputs in {watch.ops} ops: "
              f"{sorted(set(watch.wide))[:5]}") + note
    return _result("dtype", program, ok, detail)


def check_storage(program: str, caller: Dict[str, tuple], caller_after: Dict[str, tuple],
                  batch_lists=(), graph_before=None, graph_after=None,
                  graph_values_ok: Optional[bool] = None) -> Dict[str, Any]:
    """The caller's state kept every tensor leaf; each batch list handed to
    ``run_round_donated`` emptied; a graph's static state on the same
    storage from block to block and holding the state it returned."""
    bad = []
    changed = sorted(p for p in caller if caller_after.get(p) != caller[p])
    if changed:
        bad.append(f"the round wrote or replaced the caller's state at {changed[:4]}")
    kept = [i for i, b in enumerate(batch_lists) if len(b)]
    if kept:
        bad.append(f"batch list(s) {kept} not emptied: the batch was not handed over")
    parts = [f"the caller's state intact in each call ({len(caller)} tensor leaves in all)"]
    if batch_lists:
        parts.append(f"{len(batch_lists)} batch list(s) emptied by run_round_donated")
    if graph_before is not None:
        moved = sorted(p for p in graph_before
                       if graph_after.get(p, (None, None))[1] != graph_before[p][1])
        if moved or set(graph_before) != set(graph_after):
            bad.append(f"the graph's static state moved to new storage at {moved[:4]}")
        if graph_values_ok is False:
            bad.append("the graph's static state does not hold the state the block returned")
        parts.append(f"graph state on the same storage from block to block "
                     f"({len(graph_before)} tensor leaves, written back in place)")
    else:
        parts.append("eager: the engine donates no state, only the batch")
    return _result("storage", program, not bad, "; ".join(bad) if bad else "; ".join(parts))


def _max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _close(a, b, rtol: float, atol: float) -> bool:
    return bool(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol))


def check_sharding(program: str, plain: dict, sharded: dict) -> Dict[str, Any]:
    """The sharded call's rows and new params against the plain call's:
    ``plain`` / ``sharded`` hold ``rows`` (the post-attack ``[K, D]``
    matrix, or None where the program keeps none) and ``params`` (the new
    params' tensor leaves in order)."""
    bad, parts = [], []
    if plain["rows"] is not None and sharded["rows"] is not None:
        diff = _max_diff(sharded["rows"], plain["rows"])
        parts.append(f"rows {tuple(plain['rows'].shape)} max |diff| {diff:.3g}")
        if not _close(sharded["rows"], plain["rows"], **_ROWS_TOL):
            bad.append(f"the sharded rows differ from the unsharded ones by {diff:.3g} "
                       "(a row of update + params?)")
    elif (plain["rows"] is None) != (sharded["rows"] is None):
        bad.append("one engine kept its rows and the other did not")
    diffs = [_max_diff(s, p) for s, p in zip(sharded["params"], plain["params"])]
    parts.append(f"{len(diffs)} param leaves max |diff| {max(diffs, default=0.0):.3g}")
    if len(sharded["params"]) != len(plain["params"]) or not all(
            _close(s, p, **_PARAMS_TOL) for s, p in zip(sharded["params"], plain["params"])):
        bad.append("the sharded program's new params differ from the unsharded program's")
    return _result("sharding_axis", program, not bad,
                   "; ".join(bad) if bad else
                   f"virtual {_MESH_SHAPE} mesh, its batches placed by mesh rows, "
                   "equals the unsharded program: "
                   + ", ".join(parts))


def _call_result(engine, new_state) -> dict:
    """A call's rows (``engine.last_updates``, None after a block or a
    streaming round) and its new params' leaves, copied."""
    params = [t.detach().clone() for p, t in _leaves(new_state) if ".params" in p]
    rows = engine.last_updates
    return {"rows": None if rows is None else rows.detach().clone(), "params": params}


def check_rebuild(program: str, deltas: List[Dict[str, int]]) -> Dict[str, Any]:
    """The second call's deltas (``deltas[-1]``) all zero."""
    second = deltas[-1]
    ok = not any(second.values())
    return _result("rebuild_stability", program, ok,
                   f"per call {deltas} (the second must be all 0)")


# -- running one program twice ------------------------------------------------------


def _graph_of(engine):
    return engine.last_graph if engine.last_block_mode == "graph" else None


def audit_program(program: str, get_engine: Callable[[], Any], state, call: Callable,
                  cache, sharded_engine: Callable[[], Any]) -> List[Dict[str, Any]]:
    """Run ``call(engine, state) -> (new state, outputs, batch lists)``
    twice, the second from the first's new state, with ``get_engine()``
    looked up before each call; then once on ``sharded_engine()`` from the
    first call's state; return the four checks. ``cache``: the
    ``EngineCache`` ``get_engine`` reads, whose growth the rebuild check
    counts."""
    from blades_tpu_torch.telemetry.recorder import (
        Recorder,
        get_recorder,
        process_counters,
        set_recorder,
    )

    prev = get_recorder()
    rec = Recorder(path=None, enabled=True)
    set_recorder(rec)
    deltas: List[Dict[str, int]] = []
    caller, caller_after, batches, graph_snaps = {}, {}, [], []
    watch, first_outs, values_ok = DtypeWatch(), None, None
    state0, plain = state, None
    try:
        for i in range(2):
            counters0 = process_counters()
            records0 = len(rec.records)
            entries0 = len(cache)
            engine = get_engine()
            before = storage_snapshot(state)
            if i == 0:
                with watch:
                    new_state, first_outs, lists = call(engine, state)
                plain = _call_result(engine, new_state)
            else:
                new_state, _, lists = call(engine, state)
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            counters = process_counters()
            builds = [r for r in rec.records[records0:]
                      if r.get("t") == "program" and r.get("outcome") != "warm-reuse"]
            deltas.append({
                **{n: int(counters.get(n, 0) - counters0.get(n, 0)) for n in REBUILD_COUNTERS},
                "program_builds": len(builds),
                "cache_growth": len(cache) - entries0,
            })
            after = storage_snapshot(state)
            caller.update({f"call{i}:{p}": v for p, v in before.items()})
            caller_after.update({f"call{i}:{p}": v for p, v in after.items()})
            batches.extend(lists)
            graph = _graph_of(engine)
            if graph is not None:
                graph_snaps.append(storage_snapshot(graph.state))
                # a map-mode batch replays one graph per experiment: its
                # state then holds the last experiment's
                values_ok = all(
                    torch.equal(g, n) or (n.dim() == g.dim() + 1 and torch.equal(g, n[-1]))
                    for (_, g), (_, n) in zip(_leaves(graph.state), _leaves(new_state)))
            state = new_state
        # the sharding check: the same first call on a plan's engine
        s_engine = sharded_engine()
        sharded = _call_result(s_engine, call(s_engine, state0)[0])
        if s_engine.device.type == "cuda":
            torch.cuda.synchronize(s_engine.device)
    finally:
        set_recorder(prev)
    graph_kw = {}
    if len(graph_snaps) == 2:
        graph_kw = dict(graph_before=graph_snaps[0], graph_after=graph_snaps[1],
                        graph_values_ok=values_ok)
    return [
        check_storage(program, caller, caller_after, batches, **graph_kw),
        check_dtype(program, watch, first_outs),
        check_sharding(program, plain, sharded),
        check_rebuild(program, deltas),
    ]


def round_call(seed: int = 3, batch_fn: Optional[Callable[[], list]] = None):
    """A dense, streaming or async round through ``run_round_donated`` on a
    fresh batch list each call (placed by the rows of the engine's plan)."""

    def call(engine, state):
        batch = place_batch(engine, batch_fn() if batch_fn is not None
                            else toy_batch(engine.device))
        new_state, metrics = engine.run_round_donated(state, batch, 0.1, 1.0, seed)
        return new_state, engine.round_outputs(metrics), [batch]

    return call


def block_call(sampler, rounds: int = _BLOCK_ROUNDS, seed: int = 3):
    """A block of ``rounds`` rounds with ``sampler`` fused in, continuing
    from the state's round; an engine with a plan gets one sampler of its
    own whose batches are placed by the plan's rows."""
    placed = {}

    def call(engine, state):
        start = int(state.round_idx)
        r = list(range(start, start + rounds))
        source = sampler
        if engine.plan is not None:
            source = placed.setdefault(
                id(engine), lambda gen: tuple(place_batch(engine, sampler(gen))))
        new_state, metrics, diags = engine.run_block(
            state, r, [0.1] * rounds, [1.0] * rounds, seed, sampler=source)
        return new_state, (metrics, diags), []

    return call


# -- the auditor -----------------------------------------------------------------


def run_tier_b(device=None, engine_cls=None,
               programs: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Audit the round, block, streaming, experiment-batch (map and vmap)
    and buffered-async programs on ``device`` (the card by default; the
    tests pass ``"cpu"``); ``engine_cls``: a ``RoundEngine`` subclass to
    audit in place of the engine; ``programs``: a subset of
    :data:`PROGRAMS` (default all). Returns ``{"checks": [...],
    "programs": [...], "violations": N, "ok": bool}``; a ``skipped`` check
    (``ok`` None) is neither a pass nor a violation."""
    from blades_tpu_torch.core import ExperimentBatch
    from blades_tpu_torch.core.engine import resolve_device
    from blades_tpu_torch.parallel.mesh import make_mesh, make_plan
    from blades_tpu_torch.sweeps import EngineCache

    dev = resolve_device(device if device is not None else "cuda")
    wanted = set(PROGRAMS if programs is None else programs)
    unknown = sorted(wanted - set(PROGRAMS))
    if unknown:
        raise ValueError(f"unknown Tier-B program(s) {unknown}; known: {list(PROGRAMS)}")
    cache = EngineCache()
    checks: List[Dict[str, Any]] = []

    def cached(**kw):
        engine, params = build_engine(dev, engine_cls=engine_cls, **kw)
        cache.put(engine_key(engine_cls, **kw), engine)

        def get():
            # a fresh configuration each call, keyed as Simulator.run keys it
            key = engine_key(engine_cls, **kw)
            hit = cache.get(key)
            if hit is None:
                hit = build_engine(dev, engine_cls=engine_cls, **kw)[0]
                cache.put(key, hit)
            return hit

        return engine, params, get, lambda: build_engine(
            dev, engine_cls=engine_cls, plan=make_plan(make_mesh([dev] * 8, _MESH_SHAPE)),
            **kw)[0]

    # -- the dense round -------------------------------------------------------------
    if "round" in wanted:
        engine, params, get, sharded = cached()
        checks += audit_program("round", get, engine.init(params), round_call(), cache,
                                sharded)

    # -- the round block (a graph on the card, eager on the CPU) ----------------------
    if "block" in wanted:
        engine, params, get, sharded = cached()
        checks += audit_program("block", get, engine.init(params),
                                block_call(toy_sampler(dev)), cache, sharded)

    # -- the streaming round -----------------------------------------------------------
    if "streaming" in wanted:
        engine, params, get, sharded = cached(streaming=True, client_chunks=_CHUNKS)
        checks += audit_program("streaming", get, engine.init(params), round_call(), cache,
                                sharded)

    # -- ExperimentBatch, map and vmap -------------------------------------------------
    for mode in ("map", "vmap"):
        if f"experiment_batch_{mode}" not in wanted:
            continue
        engine, params, get, sharded = cached()

        def batch_call(eng, states, mode=mode):
            cx, cy = place_batch(eng, toy_batch(eng.device))
            new_states, metrics, diags = ExperimentBatch(eng, _S, mode=mode).run_round_batch(
                states, cx, cy, [0.1] * _S, [1.0] * _S, list(range(_S)), shared_data=True)
            return new_states, (metrics, diags), []

        states = ExperimentBatch(engine, _S, mode=mode).init_batch(params)
        checks += audit_program(f"experiment_batch_{mode}", get, states,
                                batch_call, cache, sharded)

    # -- the buffered-async round ---------------------------------------------------------
    if "async" in wanted:
        engine, params, get, sharded = cached(use_async=True)
        checks += audit_program("async", get, engine.init(params), round_call(), cache,
                                sharded)

    violations = [c for c in checks if c["ok"] is False]
    return {
        "checks": checks,
        "programs": sorted({c["program"] for c in checks}),
        "violations": len(violations),
        "ok": not violations,
    }
