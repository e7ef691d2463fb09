"""``ExperimentBatch`` (map mode), ``stack_experiments`` /
``unstack_experiments``, the port's ``sweeps`` copies
(``static_fingerprint``, ``program_fingerprint``, ``EngineCache``) and
``Simulator.run(engine_cache=...)``.

``ExperimentBatch`` is held to the JAX package's ``ExperimentBatch(mode=
"map").run_round_batch`` on the same shared batches, with an MLP under
ALIE and trimmed mean (a round that draws nothing), at ``rtol=1e-4,
atol=1e-5`` (the tolerance of one K=10 MLP round, ``PERF.md`` section 2);
its columns are held to each experiment's own ``run_round`` /
``run_block`` bit for bit. The fingerprints are held to the JAX
functions' on inputs that need no JAX (dicts, lists, numpy arrays,
dataclasses, the fault model).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.core import ExperimentBatch as JaxExperimentBatch
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu.sweeps import program_fingerprint as jax_program_fingerprint
from blades_tpu.sweeps import static_fingerprint as jax_static_fingerprint
from blades_tpu_torch import Simulator
from blades_tpu_torch.aggregators import Trimmedmean, get_aggregator
from blades_tpu_torch.attackers import Alie, get_attack
from blades_tpu_torch.core import (
    ExperimentBatch,
    RoundEngine,
    stack_experiments,
    unstack_experiments,
)
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.models import create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.sweeps import (
    EngineCache,
    contains_callables,
    program_fingerprint,
    static_fingerprint,
)
from blades_tpu_torch.utils import rng
from test_torch_blocks import SEED, _assert_states_equal, _engine, _fixture, _same
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

K, F, SE, B = 10, 4, 2, 8
TOL = dict(rtol=1e-4, atol=1e-5)


# -- against the JAX package -------------------------------------------------------


def test_map_mode_matches_jax_on_shared_batches():
    """S=2 experiments (different learning rates) on one shared batch, one
    round each, the MLP at K=10 under ALIE (f=4) and trimmed mean (b=4)."""
    jparams = jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))
    r = np.random.RandomState(11)
    cx = r.randn(K, 1, B, 28, 28, 1).astype(np.float32)
    cy = r.randint(0, 10, (K, 1, B)).astype(np.int32)
    c_lrs, s_lrs = [0.1, 0.05], [1.0, 0.5]

    jspec = jax_mlp()
    jeng = JaxRoundEngine(jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=K,
                          num_byzantine=F, attack=JaxAlie(num_clients=K, num_byzantine=F),
                          aggregator=JaxTrimmedmean(num_byzantine=F), plan=None)
    jbatch = JaxExperimentBatch(jeng, SE, mode="map")
    jstates, jms, _ = jbatch.run_round_batch(
        jbatch.init_batch(jparams), jnp.asarray(cx), jnp.asarray(cy), c_lrs, s_lrs,
        jnp.stack([jax.random.PRNGKey(s) for s in range(SE)]))

    tspec = create_mnist_model()
    tparams = params_from_jax(jparams, tspec.layout)
    teng = RoundEngine(tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout,
                       num_clients=K, num_byzantine=F, attack=Alie(num_clients=K, num_byzantine=F),
                       aggregator=Trimmedmean(num_byzantine=F), device="cpu")
    tbatch = ExperimentBatch(teng, SE)
    tstates, tms, diags = tbatch.run_round_batch(
        tbatch.init_batch(tparams), torch.from_numpy(cx), torch.from_numpy(cy), c_lrs, s_lrs,
        seeds=[0, 1])
    assert teng.last_block_mode == "eager"
    assert diags["faults"] is None and diags["async"] is None
    assert tms.train_loss.shape == (SE,)
    jcols = [jax.tree_util.tree_map(lambda a: a[i], jstates) for i in range(SE)]
    for s, (jst, tst) in enumerate(zip(jcols, unstack_experiments(tstates))):
        np.testing.assert_allclose(ravel(tst.params, tspec.layout).numpy(),
                                   np.asarray(ravel_pytree(jst.params)[0]), **TOL)
        for name, jcol, tcol in zip(tms._fields, jms, tms):
            atol = 1e-12 if name.startswith("update_variance") else TOL["atol"]
            np.testing.assert_allclose(float(tcol[s]), float(jcol[s]), rtol=TOL["rtol"],
                                       atol=atol, err_msg=name)
    assert tstates.round_idx == 1


# -- columns against each experiment's own run ----------------------------------------


def _tiny_engine(agg="median", **kw):
    ds, w0 = _fixture("cpu")
    kws = {"num_byzantine": 2} if agg in ("trimmedmean", "krum", "multikrum", "dnc") else {}
    eng = _engine(w0, "cpu", aggregator=get_aggregator(agg, **kws), num_byzantine=2,
                  attack=get_attack("noise"), **kw)
    return ds, w0, eng


@pytest.mark.parametrize("agg", ["median", "dnc", "centeredclipping"])
def test_run_round_batch_columns_match_run_round(agg):
    """Per-experiment ``[S, K, ...]`` data, seeds and learning rates: column
    s is experiment s's own ``run_round``, bit for bit."""
    ds, w0, eng = _tiny_engine(agg, fault_model=FaultModel(dropout_rate=0.3))
    batches = [ds.sample_round(rng.generator(SEED, r, rng.DATA), 2, 4) for r in (1, 2, 3)]
    cx, cy = (torch.stack(parts) for parts in zip(*batches))
    seeds, c_lrs, s_lrs = [4, 5, 6], [0.1, 0.2, 0.3], [1.0, 0.5, 1.0]
    eb = ExperimentBatch(eng, 3)
    states, ms, diags = eb.run_round_batch(eb.init_batch(w0), cx, cy, c_lrs, s_lrs, seeds)
    for s, got in enumerate(unstack_experiments(states)):
        ref, m = eng.run_round(eng.init(w0), cx[s], cy[s], c_lrs[s], s_lrs[s], seeds[s])
        _assert_states_equal(ref, got)
        assert all(_same(a, col[s]) for a, col in zip(m, ms))
        assert _same(eng.last_fault_diag["participants"], diags["faults"]["participants"][s])


def test_run_block_batch_columns_match_run_block():
    ds, w0, eng = _tiny_engine("trimmedmean")
    rounds = [[1, 11], [2, 12], [3, 13]]  # [R, S]
    c_lrs = [[0.2, 0.1], [0.1, 0.05], [0.05, 0.02]]
    s_lrs = [[1.0, 0.5]] * 3
    seeds = [7, 8]
    eb = ExperimentBatch(eng, 2)
    states, ms, _ = eb.run_block_batch(eb.init_batch(w0), rounds, c_lrs, s_lrs, seeds,
                                       sampler=ds.sampler(2, 4))
    assert ms.train_loss.shape == (3, 2)
    for s, got in enumerate(unstack_experiments(states)):
        col = lambda t: [row[s] for row in t]  # noqa: E731
        ref, m, _ = eng.run_block(eng.init(w0), col(rounds), col(c_lrs), col(s_lrs), seeds[s],
                                  sampler=ds.sampler(2, 4))
        _assert_states_equal(ref, got)
        assert all(_same(a, b[:, s]) for a, b in zip(m, ms))


def test_shared_data_and_validation():
    ds, w0, eng = _tiny_engine()
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA), 2, 4)
    eb = ExperimentBatch(eng, 2)
    states, ms, _ = eb.run_round_batch(eb.init_batch(w0), cx, cy, [0.1, 0.1], [1.0, 1.0],
                                       [3, 3])
    a, b = unstack_experiments(states)
    _assert_states_equal(a, b)  # one batch, one seed, one rate: one result
    # S == K: the layout of cx cannot tell shared from per-experiment data
    eb6 = ExperimentBatch(eng, 6)
    with pytest.raises(ValueError, match="ambiguous"):
        eb6.run_round_batch(eb6.init_batch(w0), cx, cy, [0.1] * 6, [1.0] * 6, list(range(6)))
    with pytest.raises(ValueError, match="seeds"):
        eb.run_round_batch(eb.init_batch(w0), cx, cy, [0.1] * 2, [1.0] * 2, [1])
    # vmap mode is ported (tests/test_torch_experiments_vmap.py)
    assert ExperimentBatch(eng, 2, mode="vmap").mode == "vmap"
    with pytest.raises(ValueError, match="mode"):
        ExperimentBatch(eng, 2, mode="pmap")


def test_stack_unstack_roundtrip():
    trees = [{"a": torch.arange(3) + i, "b": (torch.ones(2) * i,), "r": 5} for i in range(4)]
    stacked = stack_experiments(trees)
    assert stacked["a"].shape == (4, 3) and stacked["r"] == 5
    for t, back in zip(trees, unstack_experiments(stacked)):
        assert torch.equal(t["a"], back["a"]) and torch.equal(t["b"][0], back["b"][0])
    with pytest.raises(ValueError, match="non-tensor"):
        stack_experiments([{"r": 1}, {"r": 2}])


# -- the sweeps copies ------------------------------------------------------------------


@dataclasses.dataclass
class _Cfg:
    lr: float = 0.1
    steps: tuple = (1, 2)
    name: str = "x"


FINGERPRINT_CASES = {
    "scalars": {"a": 1, "b": 2.5, "c": None, "d": True, "e": "s"},
    "nested": {"z": [1, (2, 3), {"y": [None, "q"]}], "a": {"k": {"j": 1}}},
    "arrays": {"x": np.arange(12, dtype=np.float32).reshape(3, 4),
               "m": np.array([True, False]), "i": np.int64(3)},
    "dataclass": {"cfg": _Cfg(), "more": [_Cfg(lr=0.2, steps=(3,))]},
    "fault_models": {"nan": None, "faults": [("dropout_rate", 0.1), ("max_staleness", 2)]},
}


@pytest.mark.parametrize("case", sorted(FINGERPRINT_CASES))
def test_fingerprints_match_jax(case):
    parts = FINGERPRINT_CASES[case]
    assert static_fingerprint(parts) == jax_static_fingerprint(parts)
    assert program_fingerprint(**parts) == jax_program_fingerprint(**parts)
    view = static_fingerprint(parts)
    assert program_fingerprint(view=view) == jax_program_fingerprint(view=view)


@pytest.mark.parametrize("mode", ["nan", "inf", "bitflip"])
def test_fault_model_fingerprint_matches_jax(mode):
    kw = dict(dropout_rate=0.1, corrupt_rate=0.2, corrupt_mode=mode,
              participation_schedule=[[True, False], [False, True]])
    assert static_fingerprint(FaultModel(**kw)) == jax_static_fingerprint(JaxFaultModel(**kw))
    # the NaN and Inf fills ride the state: one program
    if mode == "inf":
        nan = static_fingerprint(FaultModel(**{**kw, "corrupt_mode": "nan"}))
        assert static_fingerprint(FaultModel(**kw)) == nan


def test_fingerprint_of_tensors_and_callables():
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert static_fingerprint(torch.from_numpy(arr)) == jax_static_fingerprint(arr)
    assert static_fingerprint(torch.zeros(3)) != static_fingerprint(torch.ones(3))
    assert contains_callables(static_fingerprint({"fn": lambda: 0}))
    assert not contains_callables(static_fingerprint({"agg": get_aggregator("krum")}))
    # every constructor attribute of a defense is in its key
    assert (program_fingerprint(agg=get_aggregator("trimmedmean", num_byzantine=2))
            != program_fingerprint(agg=get_aggregator("trimmedmean", num_byzantine=3)))


def test_engine_cache_hits_misses_and_lru_eviction():
    cache = EngineCache(max_entries=2)
    assert cache.get("a") is None and cache.misses == 1
    cache.put("a", 1, build_s=0.5)
    cache.put("b", 2)
    assert cache.get("a") == 1 and cache.hits == 1
    cache.put("c", 3)  # evicts b, the least recently used
    assert cache.evictions == 1 and len(cache) == 2
    assert cache.get("b") is None and cache.get("a") == 1 and cache.get("c") == 3
    stats = cache.stats()
    assert stats["entries"] == 2 and stats["hits"] == 3 and stats["misses"] == 2
    assert stats["by_key"]["a"]["build_s"] == 0.5 and stats["by_key"]["a"]["hits"] == 2


# -- Simulator.run(engine_cache=...) ---------------------------------------------------


def _run(tmp_path, name, fl, **kw):
    sim = Simulator(fl, attack="alie", num_byzantine=2, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": 2}, seed=5, device="cpu",
                    log_path=str(tmp_path / name))
    sim.run("mlp", global_rounds=3, local_steps=1, train_batch_size=4, validate_interval=3,
            block_size=2, **kw)
    return sim


def test_simulator_engine_cache_hit_matches_a_fresh_engine(tmp_path):
    fl = Synthetic(num_clients=6, train_size=240, test_size=60, cache=False).get_dls("cpu")
    cache = EngineCache()
    first = _run(tmp_path, "first", fl, engine_cache=cache,
                 fault_model={"corrupt_rate": 0.3, "corrupt_mode": "nan"})
    second = _run(tmp_path, "second", fl, engine_cache=cache,
                  fault_model={"corrupt_rate": 0.3, "corrupt_mode": "inf"})
    assert (cache.hits, cache.misses, len(cache)) == (1, 1, 1)
    assert second.engine is first.engine
    assert second.engine.fault_model.corrupt_mode == "inf"  # rebound on the hit
    fresh = _run(tmp_path, "fresh", fl, fault_model={"corrupt_rate": 0.3, "corrupt_mode": "inf"})
    assert fresh.engine is not first.engine
    _assert_states_equal(fresh.server.state, second.server.state)
    # a different configuration misses
    _run(tmp_path, "other", fl, engine_cache=cache, client_chunks=2)
    assert (cache.hits, cache.misses, len(cache)) == (1, 2, 2)


def test_simulator_engine_cache_keys_on_alies_z(tmp_path):
    """ALIE's ``z`` override is part of the configuration: a run with
    another ``z`` misses and builds its own engine, whose round uses it."""
    fl = Synthetic(num_clients=6, train_size=240, test_size=60, cache=False).get_dls("cpu")
    cache = EngineCache()

    def run(name, z):
        sim = Simulator(fl, attack="alie", attack_kws={"z": z}, num_byzantine=2,
                        aggregator="mean", seed=5, device="cpu", log_path=str(tmp_path / name))
        sim.run("mlp", global_rounds=1, local_steps=1, train_batch_size=4, engine_cache=cache)
        return sim

    a, b = run("a", 1.0), run("b", 3.0)
    assert (cache.hits, cache.misses, len(cache)) == (0, 2, 2)
    assert b.engine is not a.engine and b.engine.attack.z == 3.0
    assert not torch.equal(ravel(a.server.state.params, a.engine.layout),
                           ravel(b.server.state.params, b.engine.layout))
    assert run("c", 3.0).engine is b.engine and cache.hits == 1


def test_simulator_engine_cache_bypassed_for_registered_attackers(tmp_path):
    from blades_tpu_torch.client import ByzantineClient

    fl = Synthetic(num_clients=6, train_size=240, test_size=60, cache=False).get_dls("cpu")
    cache = EngineCache()
    sim = Simulator(fl, aggregator="median", device="cpu", log_path=str(tmp_path / "c"))
    sim.register_attackers([ByzantineClient(attack=get_attack("signflipping"))])
    sim.run("mlp", global_rounds=1, train_batch_size=4, engine_cache=cache)
    assert (cache.hits, cache.misses, len(cache)) == (0, 0, 0)
