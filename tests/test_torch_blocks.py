"""Round blocks of the port (``RoundEngine.run_block``,
``Simulator.run(block_size=...)``): an R-round block against R sequential
``run_round`` calls, bit for bit, as ``tests/test_engine.py:405-580``
holds the JAX package's blocks.

The registry-wide cases use a tiny linear model (D = 48, as the JAX
harness) with one dropout site, so every block draws from the round's
``DATA``, ``DROPOUT``, ``ATTACK``, ``FAULT``, ``AGG`` and ``ARRIVAL``
generators. On the CPU a block runs eagerly; the cases marked ``cuda`` run
the captured CUDA graph (``core/graphs.py``) on the card and skip here:
``python -m pytest --noconftest tests/test_torch_blocks.py`` there. The
file imports nothing of JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from blades_tpu_torch import Simulator
from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator
from blades_tpu_torch.aggregators import _wrap_callable
from blades_tpu_torch.asyncfl import AsyncConfig
from blades_tpu_torch.attackers import ATTACKS, get_attack
from blades_tpu_torch.client import ByzantineClient
from blades_tpu_torch.core import ClientOptSpec, RoundEngine
from blades_tpu_torch.datasets import FLDataset, Synthetic
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.ops.pytree import FlatLayout, LeafSpec
from blades_tpu_torch.simulator import _CompositeAttack
from blades_tpu_torch.utils import rng
from blades_tpu_torch.utils.logging import read_stats

K, F, C, SEED = 6, 12, 4, 7
S, B = 2, 4
LAYOUT = FlatLayout((LeafSpec("w", ("w",), (F, C)),))
LRS = (0.2, 0.1, 0.05)
#: graph-unsafe by declaration: a host-side stopping rule each iteration
HOST_SYNC_AGGREGATORS = ("autogm", "geomed")


def _tiny_loss(p, x, y, noise):
    x = x.reshape(x.shape[0], -1)
    if noise:
        x = torch.where(noise["drop"], x / 0.8, torch.zeros_like(x))
    logits = x @ p["w"]
    loss = -torch.log_softmax(logits, -1).gather(-1, y.long()[:, None]).mean()
    return loss, {"top1": (logits.argmax(-1) == y).to(torch.float32).mean()}


def _tiny_logits(p, x):
    return x.reshape(x.shape[0], -1) @ p["w"]


def _tiny_noise(batch):
    return {"drop": ((batch, F), 0.8)}


def _fixture(device, seed=0):
    r = np.random.RandomState(seed)
    ds = FLDataset(
        r.randn(K, 20, F).astype(np.float32),
        r.randint(0, C, (K, 20)).astype(np.int64),
        np.full(K, 20, np.int64),
        r.randn(30, F).astype(np.float32),
        r.randint(0, C, 30).astype(np.int64),
        device=device,
    )
    w0 = {"w": torch.from_numpy(r.randn(F, C).astype(np.float32) * 0.1)}
    return ds, w0


def _engine(w0, device, **kw):
    return RoundEngine(_tiny_loss, _tiny_logits, w0, LAYOUT, num_clients=K, num_classes=C,
                       device=device, noise_sites=_tiny_noise, **kw)


def _same(a, b) -> bool:
    """Bit-identical tensors, NaN where NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _assert_states_equal(a, b):
    assert a.round_idx == b.round_idx
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert _same(x, y.to(x.device))


def block_vs_sequential(device, rounds=3, block_split=None, **engine_kw):
    """Run R sequential rounds and the same R rounds as blocks (one block,
    or blocks of the sizes in ``block_split``) from one init, and assert
    they are bit-identical: params and every state leaf, ``round_idx``,
    every metric and the fault and async counters of every round."""
    ds, w0 = _fixture(device)
    eng = _engine(w0, device, **engine_kw)
    st = eng.init(w0)
    seq = []
    for i, r in enumerate(range(1, rounds + 1)):
        cx, cy = ds.sample_round(rng.generator(SEED, r, rng.DATA, device=device), S, B)
        st, m = eng.run_round(st, cx, cy, LRS[i % 3], 1.0, SEED)
        seq.append((m, eng.last_fault_diag, eng.last_async_diag))

    st2, first = eng.init(w0), 1
    blocks = []
    for size in block_split or [rounds]:
        rs = list(range(first, first + size))
        st2, ms, diags = eng.run_block(st2, rs, [LRS[(r - 1) % 3] for r in rs], [1.0] * size,
                                       SEED, sampler=ds.sampler(S, B))
        blocks.append((ms, diags))
        first += size
    _assert_states_equal(st, st2)
    i = 0
    for ms, diags in blocks:
        for j in range(ms.train_loss.shape[0]):
            m, fdiag, adiag = seq[i]
            for name, a, col in zip(m._fields, m, ms):
                assert _same(a, col[j]), (name, i)
            for ref, got in ((fdiag, diags["faults"]), (adiag, diags["async"])):
                assert (ref is None) == (got is None)
                for name in ref or {}:
                    assert _same(ref[name], got[name][j]), (name, i)
            i += 1
    assert i == rounds
    assert diags["defense"] is None and diags["audit"] is None and diags["metrics"] is None
    assert eng.last_updates is None
    return eng, diags


def _registry_kwargs(agg, device):
    agg_kws = {"num_byzantine": 2} if agg in ("trimmedmean", "krum", "multikrum", "dnc") else {}
    kw = dict(aggregator=get_aggregator(agg, **agg_kws), num_byzantine=2,
              attack=get_attack("ipm", epsilon=0.5))
    if agg == "fltrust":
        trusted = torch.zeros(K, dtype=torch.bool)
        trusted[-1] = True
        kw["trusted_mask"] = trusted
    return kw


@pytest.mark.parametrize("agg", sorted(AGGREGATORS))
def test_block_matches_sequential_across_registry(agg):
    eng, _ = block_vs_sequential("cpu", **_registry_kwargs(agg, "cpu"))
    assert eng.last_block_mode == "eager" and "cpu" in eng.last_block_reason


def test_block_matches_sequential_with_persisted_opt_and_faults():
    """Persistent Adam state, stragglers with their replay buffer, dropout
    and NaN corruption: every carried surface at once, with the stacked
    fault counters."""
    _, diags = block_vs_sequential(
        "cpu", block_split=[2, 1],
        aggregator=get_aggregator("median"), num_byzantine=2,
        attack=get_attack("signflipping"),
        client_opt=ClientOptSpec(name="adam", persist=True),
        fault_model=FaultModel(dropout_rate=0.3, straggler_rate=0.4, max_staleness=2,
                               corrupt_rate=0.2, corrupt_mode="nan"),
    )
    assert diags["faults"]["participants"].shape == (1,)


def test_block_matches_sequential_with_schedule_and_bitflips():
    """The participation schedule's row comes from the device round index."""
    sched = np.array([[True] * K, [False, True] * (K // 2), [True, False] * (K // 2)])
    block_vs_sequential(
        "cpu", rounds=4, aggregator=get_aggregator("trimmedmean", num_byzantine=1),
        num_byzantine=1, attack=get_attack("noise"),
        fault_model=FaultModel(participation_schedule=sched, corrupt_rate=0.3,
                               corrupt_mode="bitflip"),
    )


@pytest.mark.parametrize("arrivals", [{"kind": "uniform", "max_delay": 2},
                                      {"kind": "geometric", "mean_delay": 1.0, "max_delay": 3},
                                      {"kind": "zero"}])
def test_async_block_matches_sequential(arrivals):
    """Async ticks in a block (JAX ``tests/test_asyncfl.py:324``): the
    version ring, the buffer, the countdowns and the 10 counters."""
    _, diags = block_vs_sequential(
        "cpu", rounds=4, aggregator=get_aggregator("trimmedmean", num_byzantine=1),
        num_byzantine=2, attack=get_attack("alie", num_clients=K, num_byzantine=2),
        client_opt=ClientOptSpec(name="sgd", momentum=0.9, persist=True),
        fault_model=None if arrivals["kind"] == "zero" else FaultModel(dropout_rate=0.2),
        async_config=AsyncConfig(buffer_m=K if arrivals["kind"] == "zero" else 3,
                                 arrivals=arrivals, staleness="polynomial"),
    )
    assert diags["async"]["fires_total"].shape == (4,)


def test_streaming_block_runs_eagerly_and_matches_sequential():
    eng, _ = block_vs_sequential(
        "cpu", aggregator=get_aggregator("trimmedmean", num_byzantine=1), num_byzantine=1,
        attack=get_attack("noise"), client_chunks=2, streaming=True,
        fault_model=FaultModel(dropout_rate=0.2, corrupt_rate=0.3, corrupt_mode="bitflip"),
    )
    assert eng.last_block_mode == "eager"


def test_run_block_checks_its_arguments():
    ds, w0 = _fixture("cpu")
    eng = _engine(w0, "cpu", aggregator=get_aggregator("mean"))
    with pytest.raises(ValueError, match="sampler"):
        eng.run_block(eng.init(w0), [1, 2], [0.1] * 2, [1.0] * 2, SEED)
    with pytest.raises(ValueError, match="learning rate"):
        eng.run_block(eng.init(w0), [1, 2], [0.1], [1.0] * 2, SEED, sampler=ds.sampler(S, B))


# -- the graph-safety decision ---------------------------------------------------


@pytest.mark.parametrize("agg", sorted(AGGREGATORS))
def test_graph_safety_of_each_aggregator(agg):
    reason = get_aggregator(agg).graph_unsafe_reason
    if agg in HOST_SYNC_AGGREGATORS:
        assert "host" in reason
    else:
        assert reason is None


@pytest.mark.parametrize("attack", sorted(ATTACKS))
def test_graph_safety_of_each_attack(attack):
    kws = {"num_clients": K, "num_byzantine": 2} if attack == "alie" else {}
    assert get_attack(attack, **kws).graph_unsafe_reason is None


def test_graph_safety_of_the_rest():
    assert "num_byzantine" in get_attack("alie", num_clients=K).graph_unsafe_reason
    composite = _CompositeAttack([(0, ByzantineClient(attack=get_attack("noise")))])
    assert "generator" in composite.graph_unsafe_reason
    assert "callable" in _wrap_callable(lambda u: u.mean(0)).graph_unsafe_reason
    # an engine decides at build time, from its configuration alone
    _, w0 = _fixture("cpu")
    eng = _engine(w0, "cpu", aggregator=get_aggregator("trimmedmean"),
                  attack=get_attack("alie", num_clients=K, num_byzantine=2), num_byzantine=2)
    assert "cpu" in eng.graph_block_reason()
    eng.device = torch.device("cuda")
    assert eng.graph_block_reason() is None
    eng.aggregator = get_aggregator("geomed")
    assert eng.graph_block_reason().startswith("Geomed: its Weiszfeld loop")
    eng.attack = get_attack("alie", num_clients=K)
    assert eng.graph_block_reason().startswith("Alie: without num_byzantine")
    eng.attack = get_attack("alie", num_clients=K, num_byzantine=2)
    eng.aggregator, eng.streaming = get_aggregator("mean"), True
    assert "7c" in eng.graph_block_reason()


def test_an_engine_keeps_one_graph(monkeypatch):
    """A new batch source drops the engine's graph before the next one is
    made (each graph holds a round's peak in its private pool); the same
    source reuses it. ``RoundGraph`` is stood in for, so this runs here."""
    import weakref

    from blades_tpu_torch.core import graphs

    made = []

    class StandIn:
        def __init__(self, engine, state, key, sampler=None, batch=None):
            self.key = key
            made.append(weakref.ref(self))

        def run(self, eng, state, specs, batches=None):
            return state, None

    monkeypatch.setattr(graphs, "RoundGraph", StandIn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ds, w0 = _fixture("cpu")
    other, _ = _fixture("cpu", seed=1)
    eng = _engine(w0, "cpu", aggregator=get_aggregator("mean"))
    st = eng.init(w0)
    for sampler in (ds.sampler(S, B), ds.sampler(S, B), other.sampler(S, B), ds.sampler(S, 2)):
        graphs.run_graph(eng, st, [], sampler=sampler)
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA), S, B)
    graphs.run_graph(eng, st, [], batches=[(cx, cy)])
    graphs.run_graph(eng, st, [], batches=[(cx + 1, cy)])  # same shapes: same graph
    assert len(made) == 4
    assert [ref() is not None for ref in made] == [False, False, False, True]
    assert eng.last_graph is made[-1]()


# -- the sampler and the round's generators ---------------------------------------


def test_sampler_matches_sample_round():
    ds, _ = _fixture("cpu", seed=5)
    fn = ds.sampler(S, B)
    assert ds.sampler(S, B) is fn  # one sampler per shape: a graph keys on it
    cx_a, cy_a = ds.sample_round(rng.generator(2, 3, rng.DATA), S, B)
    cx_b, cy_b = fn(rng.generator(2, 3, rng.DATA))
    assert torch.equal(cx_a, cx_b) and torch.equal(cy_a, cy_b)
    assert cx_a.shape == (K, S, B, F) and cy_a.shape == (K, S, B)
    ds.to("cpu")
    # a store that stays put keeps its samplers (a Simulator calls to() on
    # the store it is given, and a cached engine's graph keys on them)
    assert ds.sampler(S, B) is fn


def test_round_streams_draw_what_new_generators_draw():
    streams = rng.RoundStreams(3, 5, data_round=6)
    for purpose in (rng.DROPOUT, rng.ATTACK, rng.AGG, rng.FAULT):
        assert streams(purpose) is streams(purpose)
        assert torch.equal(torch.rand(5, generator=streams(purpose)),
                           torch.rand(5, generator=rng.generator(3, 5, purpose)))
    assert torch.equal(torch.rand(4, generator=streams(rng.DATA)),
                       torch.rand(4, generator=rng.generator(3, 6, rng.DATA)))
    assert torch.equal(torch.rand(4, generator=streams(rng.ATTACK, chunk=1)),
                       torch.rand(4, generator=rng.generator(3, 5, rng.ATTACK, chunk=1)))
    # reseeding puts every held generator at its node of the new round
    streams.reseed(3, 8, data_round=9)
    assert torch.equal(torch.rand(5, generator=streams(rng.AGG)),
                       torch.rand(5, generator=rng.generator(3, 8, rng.AGG)))
    assert torch.equal(torch.rand(4, generator=streams(rng.DATA)),
                       torch.rand(4, generator=rng.generator(3, 9, rng.DATA)))
    assert rng.seed_of(3, 8, rng.AGG) == rng.generator(3, 8, rng.AGG).initial_seed()


def test_fault_schedule_row_takes_the_device_index():
    sched = np.array([[True, False, True], [False, True, True]])
    fm = FaultModel(participation_schedule=sched)
    for r in range(5):
        row = fm._schedule_row(torch.tensor(r), "cpu")
        assert row.tolist() == sched[r % 2].tolist() == fm._schedule_row(r, "cpu").tolist()


# -- donated batches ----------------------------------------------------------------


def test_run_round_donated_empties_the_batch_and_matches():
    ds, w0 = _fixture("cpu")
    eng = _engine(w0, "cpu", aggregator=get_aggregator("trimmedmean", num_byzantine=1),
                  num_byzantine=1, attack=get_attack("signflipping"))
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA), S, B)
    ref, m_ref = eng.run_round(eng.init(w0), cx, cy, 0.1, 1.0, SEED)
    batch = [cx.clone(), cy.clone()]
    got, m = eng.run_round_donated(eng.init(w0), batch, 0.1, 1.0, SEED)
    assert batch == []
    _assert_states_equal(ref, got)
    assert all(_same(a, b) for a, b in zip(m_ref, m))


# -- the Simulator -------------------------------------------------------------------


def _sim(tmp_path, name, **kw):
    ds = Synthetic(num_clients=7, train_size=280, test_size=70, cache=False)
    return Simulator(ds, attack="alie", num_byzantine=2, aggregator="trimmedmean",
                     aggregator_kws={"num_byzantine": 2}, seed=3, device="cpu",
                     log_path=str(tmp_path / name), **kw)


RUN = dict(global_rounds=7, local_steps=2, train_batch_size=4, validate_interval=3,
           client_lr=0.2, client_lr_scheduler={"milestones": [2, 5], "gamma": 0.5},
           fault_model={"dropout_rate": 0.2})


def test_simulator_block_size_matches_per_round(tmp_path):
    """``block_size=3`` over 7 rounds (two full blocks and a remainder):
    the stats file's records are the per-round run's, eval included (the
    evaluations fall on block ends), and so are the params."""
    one = _sim(tmp_path, "one")
    t_one = one.run("mlp", **RUN)
    blk = _sim(tmp_path, "blk")
    t_blk = blk.run("mlp", block_size=3, **RUN)
    assert len(t_one) == len(t_blk) == 7
    assert read_stats(str(tmp_path / "one")) == read_stats(str(tmp_path / "blk"))
    _assert_states_equal(one.server.state, blk.server.state)
    assert blk.engine.last_block_mode == "eager"
    train = [r["Round"] for r in read_stats(str(tmp_path / "blk")) if r["_meta"]["type"] == "train"]
    assert train == list(range(1, 8))


def test_block_size_falls_back_when_hooks_need_rounds(tmp_path):
    seen = []
    sim = _sim(tmp_path, "hook")
    sim.run("mlp", global_rounds=3, local_steps=1, train_batch_size=4, validate_interval=3,
            block_size=3, on_round_end=lambda r, s, m: seen.append(r))
    assert seen == [1, 2, 3]
    assert sim.engine.last_updates is not None  # the per-round path kept them
    assert sim.engine.last_block_mode is None  # no block ran


def test_simulator_donate_batches_matches(tmp_path):
    a = _sim(tmp_path, "a")
    a.run("mlp", **RUN)
    b = _sim(tmp_path, "b")
    b.run("mlp", donate_batches=True, **RUN)
    assert read_stats(str(tmp_path / "a")) == read_stats(str(tmp_path / "b"))
    _assert_states_equal(a.server.state, b.server.state)


# -- on the card: the captured graph -------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("agg", sorted(AGGREGATORS))
def test_graph_block_matches_sequential_across_registry(cuda_device, agg):
    eng, _ = block_vs_sequential(cuda_device, rounds=4, block_split=[3, 1],
                                 **_registry_kwargs(agg, cuda_device))
    if agg in HOST_SYNC_AGGREGATORS:
        assert eng.last_block_mode == "eager" and "host" in eng.last_block_reason
    else:
        assert eng.last_block_mode == "graph" and eng.last_block_reason is None
        assert eng.last_graph.replays == 3  # round 1 warmed up, then 2 + 1 replays


@pytest.mark.cuda
@pytest.mark.parametrize("block_split", [[2, 2], [1, 3]])
def test_graph_block_with_persisted_opt_and_faults(cuda_device, block_split):
    eng, _ = block_vs_sequential(
        cuda_device, rounds=4, block_split=block_split,
        aggregator=get_aggregator("median"), num_byzantine=2,
        attack=get_attack("signflipping"),
        client_opt=ClientOptSpec(name="adam", persist=True),
        fault_model=FaultModel(dropout_rate=0.3, straggler_rate=0.4, max_staleness=2,
                               corrupt_rate=0.2, corrupt_mode="nan"),
    )
    assert eng.last_block_mode == "graph"


@pytest.mark.cuda
def test_graph_capture_after_engines_are_dropped(cuda_device):
    """Engines that captured graphs are dropped unreferenced (an engine sits
    in a reference cycle, so a garbage collection frees its graph), then
    another engine captures: no collection may run inside that capture."""
    for agg in ("median", "trimmedmean", "mean"):
        eng, _ = block_vs_sequential(cuda_device, rounds=2, **_registry_kwargs(agg, cuda_device))
        assert eng.last_block_mode == "graph"
    del eng
    eng, _ = block_vs_sequential(
        cuda_device, rounds=4, block_split=[1, 3],
        aggregator=get_aggregator("median"), num_byzantine=2,
        attack=get_attack("ipm", epsilon=0.5),
        client_opt=ClientOptSpec(name="adam", persist=True),
        fault_model=FaultModel(dropout_rate=0.3, straggler_rate=0.4, max_staleness=2),
    )
    assert eng.last_block_mode == "graph"


@pytest.mark.cuda
def test_engine_cache_hit_on_a_new_store_keeps_one_graph(cuda_device, tmp_path):
    """A cached engine run on another store captures anew and frees the old
    graph, with its pool and its hold on the old store; the new run equals a
    fresh engine's."""
    import gc
    import weakref

    from blades_tpu_torch.sweeps import EngineCache

    cache = EngineCache()

    def run(name, data_seed, **kw):
        ds = Synthetic(num_clients=7, train_size=280, test_size=70, seed=data_seed,
                       cache=False)
        sim = Simulator(ds, attack="alie", num_byzantine=2, aggregator="trimmedmean",
                        aggregator_kws={"num_byzantine": 2}, seed=3, device=cuda_device,
                        log_path=str(tmp_path / name))
        sim.run("mlp", global_rounds=4, local_steps=2, train_batch_size=4,
                validate_interval=4, block_size=2, **kw)
        return sim

    first = run("first", 0, engine_cache=cache)
    old = weakref.ref(first.engine.last_graph)
    second = run("second", 1, engine_cache=cache)
    gc.collect()
    assert cache.hits == 1 and second.engine is first.engine
    assert old() is None and second.engine.last_graph is not None
    assert second.engine.last_block_mode == "graph"
    fresh = run("fresh", 1)
    _assert_states_equal(fresh.server.state, second.server.state)


@pytest.mark.cuda
@pytest.mark.parametrize("arrivals", [{"kind": "uniform", "max_delay": 2},
                                      {"kind": "geometric", "mean_delay": 1.0, "max_delay": 3}])
def test_graph_async_block_matches_sequential(cuda_device, arrivals):
    eng, _ = block_vs_sequential(
        cuda_device, rounds=4, aggregator=get_aggregator("trimmedmean", num_byzantine=1),
        num_byzantine=2, attack=get_attack("alie", num_clients=K, num_byzantine=2),
        fault_model=FaultModel(dropout_rate=0.2),
        async_config=AsyncConfig(buffer_m=3, arrivals=arrivals, staleness="polynomial"),
    )
    assert eng.last_block_mode == "graph"


@pytest.mark.cuda
def test_graph_counts_kernel_launches_per_replay(cuda_device):
    from blades_tpu_torch.ops import trimmed

    ds, w0 = _fixture(cuda_device)
    eng = _engine(w0, cuda_device, aggregator=get_aggregator("trimmedmean", num_byzantine=1),
                  num_byzantine=1, attack=get_attack("signflipping"))
    trimmed.trimmed_mean_launches = 0
    st, _, _ = eng.run_block(eng.init(w0), range(1, 4), [0.1] * 3, [1.0] * 3, SEED,
                             sampler=ds.sampler(S, B))
    torch.cuda.synchronize()
    assert eng.last_graph.kernel_launches == 1
    assert trimmed.trimmed_mean_launches == 3  # the warm-up round and two replays


# -- real data and resume through the captured round --------------------------------------
#
# Each case runs on the card (``cuda``) and, here, as a rehearsal: the real
# ``RoundGraph`` with its capture replaced by a Python replay of the round
# body on the static buffers, and the CUDA stream calls by no-ops, so the
# static state, the write-back and the reseeded generators run on the CPU.


class _NoStream:
    def __init__(self, *args, **kw):
        pass

    def wait_stream(self, other):
        pass


class _PythonReplay:
    """What a captured graph's replay does, in Python: the round body on
    the static buffers, its outputs packed into ``out_vecs``."""

    def __init__(self, graph, eng):
        self.graph, self.eng = graph, eng

    def replay(self):
        self.graph.out_vecs = self.graph.packer.pack(self.graph._body(self.eng))


@pytest.fixture(params=["rehearsed", pytest.param("cuda", marks=pytest.mark.cuda)])
def graph_device(request, monkeypatch):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
        return torch.device("cuda")
    import contextlib

    from blades_tpu_torch.core import graphs

    def capture(self, eng):
        self.graph, self.kernel_launches, self.capture_seconds = _PythonReplay(self, eng), 0, 0.0

    real_reason = RoundEngine.graph_block_reason

    def reason(self):  # the card's answer for this configuration
        device, self.device = self.device, torch.device("cuda")
        try:
            return real_reason(self)
        finally:
            self.device = device

    for name, value in (("Stream", _NoStream), ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda *a: _NoStream()),
                        ("synchronize", lambda *a: None), ("empty_cache", lambda: None),
                        ("is_available", lambda: True)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(graphs.RoundGraph, "_capture", capture)
    monkeypatch.setattr(RoundEngine, "graph_block_reason", reason)
    return torch.device("cpu")


def _cifar_store(device, k=K):
    """A CIFAR-shaped uint8 store whose sampler crops, flips, erases and
    normalizes."""
    from blades_tpu_torch.datasets import CustomTensorDataset
    from blades_tpu_torch.datasets.augment import cifar_train_transform, make_normalizer

    r = np.random.RandomState(3)
    x = r.randint(0, 256, (k * 24, 32, 32, 3)).astype(np.uint8)
    y = r.randint(0, C, k * 24)
    ds = CustomTensorDataset(x, y, x[:30], y[:30], transform=cifar_train_transform,
                             normalize=make_normalizer((0.49, 0.48, 0.45), (0.25, 0.24, 0.26)),
                             num_clients=k, iid=False, alpha=0.5, seed=1)
    return ds.get_dls(device)


def _store_sim(store, tmp_path, name, **kw):
    return Simulator(store, attack="alie", num_byzantine=2, aggregator="trimmedmean",
                     aggregator_kws={"num_byzantine": 1}, seed=3, device=store.device,
                     log_path=str(tmp_path / name), **kw)


def test_graph_block_from_the_cifar_sampler_matches_rounds(graph_device, tmp_path):
    """The augmenting, normalizing sampler inside the captured round: a run
    in blocks [3, 1] equals the same rounds one by one, bit for bit."""
    store = _cifar_store(graph_device)
    assert store.train_x.dtype == torch.uint8
    run = dict(global_rounds=4, local_steps=2, train_batch_size=4, validate_interval=4)
    seq = _store_sim(store, tmp_path, "seq")
    seq.run("mlp", **run)
    blk = _store_sim(store, tmp_path, "blk")
    blk.run("mlp", block_size=3, **run)
    assert blk.engine.last_block_mode == "graph"
    assert blk.engine.last_graph.replays == 3  # round 1 warmed up, rounds 2-3 and 4 replayed
    _assert_states_equal(seq.server.state, blk.server.state)
    assert read_stats(str(tmp_path / "seq"), "train") == read_stats(str(tmp_path / "blk"),
                                                                  "train")


def test_resume_into_an_engine_whose_graph_is_captured(graph_device, tmp_path):
    """A checkpoint restored into a cached engine whose round is already
    captured: ``write_back`` copies the restored state into the graph's
    static buffers, the graph is replayed, not captured again, and the run
    lands on the uninterrupted one bit for bit."""
    from blades_tpu_torch.sweeps import EngineCache

    store = _cifar_store(graph_device)
    cache, ck = EngineCache(), str(tmp_path / "ck.npz")
    run = dict(local_steps=1, train_batch_size=4, validate_interval=100, block_size=2,
               engine_cache=cache)
    _store_sim(store, tmp_path, "first").run("mlp", global_rounds=2, checkpoint_path=ck,
                                             checkpoint_interval=2, **run)
    ref = _store_sim(store, tmp_path, "ref")
    ref.run("mlp", global_rounds=6, **run)
    graph = ref.engine.last_graph
    replays = graph.replays
    resumed = _store_sim(store, tmp_path, "resumed")
    assert len(resumed.run("mlp", global_rounds=6, checkpoint_path=ck, resume=True, **run)) == 4
    assert resumed.engine is ref.engine and resumed.engine.last_graph is graph
    assert graph.replays == replays + 4
    _assert_states_equal(ref.server.state, resumed.server.state)


@pytest.mark.parametrize("faults", [None, {"dropout_rate": 0.3, "corrupt_clients": (3,)}],
                         ids=["dense", "fault-model"])
def test_diagnosed_graph_block_equals_its_rounds(graph_device, faults):
    """The forensics inside the captured round (slice 10a): with
    ``collect_diagnostics``, an ``AuditMonitor`` whose fallback is the
    trimmed mean, and ``round_metrics``, a block's stacked diagnostics
    (``[R, K]`` trim counts among them), audit fields and metric packs
    equal R sequential rounds' bit for bit; on the card the captured round
    holds two kernel launches, the defense's and the fallback's."""
    from blades_tpu_torch.audit import AuditMonitor
    from blades_tpu_torch.core.engine import BLOCK_DIAGS

    device = graph_device
    ds, w0 = _fixture(device)
    kw = dict(num_byzantine=2, attack=get_attack("alie", num_clients=K, num_byzantine=2),
              aggregator=get_aggregator("trimmedmean", num_byzantine=1), client_chunks=2,
              collect_diagnostics=True, round_metrics=True,
              audit_monitor=AuditMonitor(fallback_aggregator="trimmedmean"),
              fault_model=None if faults is None else FaultModel(**faults))
    eng = _engine(w0, device, **kw)
    st, seq = eng.init(w0), []
    for r in range(1, 4):
        cx, cy = ds.sample_round(rng.generator(SEED, r, rng.DATA, device=device), S, B)
        st, m = eng.run_round(st, cx, cy, LRS[r - 1], 1.0, SEED)
        seq.append(eng.round_outputs(m))
    blk = _engine(w0, device, **kw)
    st2, ms, diags = blk.run_block(blk.init(w0), [1, 2, 3], list(LRS), [1.0] * 3, SEED,
                                   sampler=ds.sampler(S, B))
    assert blk.last_block_mode == "graph"
    _assert_states_equal(st, st2)
    assert diags["defense"]["trim_counts"].shape == (3, K)
    assert diags["metrics"].norm_hist.shape[0] == 3
    for i, outs in enumerate(seq):
        for name, ref in zip(BLOCK_DIAGS, outs[1:]):
            got = diags[name]
            assert (ref is None) == (got is None), name
            ref_leaves, got_leaves = _leaves(ref), _leaves(got)
            assert len(ref_leaves) == len(got_leaves)
            for a, col in zip(ref_leaves, got_leaves):
                assert _same(a, col[i]), (name, i)
    if faults is None:
        assert diags["audit"]["participants"].tolist() == [K] * 3
    if device.type == "cuda":
        assert blk.last_graph.kernel_launches == (0 if faults else 2)
