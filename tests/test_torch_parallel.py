"""The port's parallel layer (``blades_tpu_torch/parallel/``, the round
engine's plan and ``Simulator(mesh_shape=...)``)
against the JAX package's on the conftest's 8-device CPU mesh.

The port's meshes are virtual: 8 entries of the CPU. Where a layout is
compared index for index, the port is handed 8 distinguishable entries
(``cuda:0`` .. ``cuda:7`` as device names; nothing runs there) in the
order of the JAX devices' ids. The rounds take the JAX init, carried over
by the MLP's weight map (``params_from_jax``), and numpy-seeded batches
handed to both. Tolerances, those of ``tests/test_engine.py:242-252``:
the post-attack update rows ``rtol=1e-4, atol=1e-6``, ``agg_norm``
``rtol=1e-4``, the new params ``rtol=1e-5, atol=1e-7``; the port's sharded
round against its unsharded round at the same bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu import Simulator as JaxSimulator
from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.datasets import Synthetic as JaxSynthetic
from blades_tpu.datasets.fl import FLDataset as JaxFLDataset
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu.parallel import distributed as jax_dist
from blades_tpu.parallel.mesh import auto_mesh_shape as jax_auto_mesh_shape
from blades_tpu.parallel.mesh import make_mesh as jax_make_mesh
from blades_tpu.parallel.mesh import make_plan as jax_make_plan
from blades_tpu_torch import Simulator
from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.asyncfl import ArrivalProcess, AsyncConfig
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.core import RoundEngine
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.datasets.fl import FLDataset
from blades_tpu_torch.models import create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.parallel import (
    CLIENTS_AXIS,
    MODEL_AXIS,
    auto_mesh_shape,
    make_mesh,
    make_plan,
)
from blades_tpu_torch.parallel import distributed as dist
from blades_tpu_torch.sweeps import EngineCache
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

K, F, S, B = 8, 2, 2, 4
CPU8 = [torch.device("cpu")] * 8
NAMED8 = [torch.device("cuda", i) for i in range(8)]
ROWS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAMS_TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = [(2, 4), (4, 2), (8, 1)]


def _ids(jmesh):
    return np.vectorize(lambda d: d.id)(jmesh.devices).tolist()


def _indices(mesh):
    return [[d.index for d in row] for row in mesh.devices]


# -- meshes ------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [None, (8, 1), (4, 2), (2, 4), (1, 8)])
def test_make_mesh_matches_jax(shape):
    jmesh = jax_make_mesh(jax.devices(), shape)
    mesh = make_mesh(NAMED8, shape)
    assert mesh.axis_names == tuple(jmesh.axis_names) == (CLIENTS_AXIS, MODEL_AXIS)
    assert mesh.shape == dict(jmesh.shape)
    assert _indices(mesh) == _ids(jmesh)
    assert mesh.ranks is None


def test_make_mesh_errors_and_virtual_entries():
    with pytest.raises(ValueError, match=r"!= 8 devices"):
        jax_make_mesh(jax.devices(), (3, 2))
    with pytest.raises(ValueError, match=r"!= 8 devices"):
        make_mesh(NAMED8, (3, 2))
    mesh = make_mesh(CPU8, (2, 4))
    assert mesh.distinct_devices() == [torch.device("cpu")]
    plan = make_plan(mesh)
    assert plan.primary == torch.device("cpu") and not plan.collective
    assert [(s.start, s.stop) for s in plan.row_ranges(10)] == [(0, 5), (5, 10)]
    assert [(s.start, s.stop) for s in plan.column_ranges(283_723)] == [
        (0, 70931), (70931, 141862), (141862, 212793), (212793, 283723)]


def test_plan_replicate_and_shard_batch():
    """The plan's counterparts of JAX's replicated and clients shardings:
    one replica per clients-axis row (the tree itself on its own device),
    and each row's contiguous range of a ``[K, ...]`` tree."""
    plan = make_plan(make_mesh(CPU8, (4, 2)))
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    replicas = plan.replicate(tree)
    assert len(replicas) == 4 and all(r["w"] is tree["w"] for r in replicas)
    rows = torch.arange(10.0)[:, None]
    pieces = plan.shard_batch(rows)
    assert [(r, p.start, p.stop) for r, p, _ in pieces] == [
        (0, 0, 3), (1, 3, 6), (2, 6, 8), (3, 8, 10)]
    assert torch.equal(torch.cat([x for _, _, x in pieces]), rows)
    parts = plan.split_rows(slice(2, 7), 10)
    assert [(r, p.start, p.stop) for r, p in parts] == [(0, 2, 3), (1, 3, 6), (2, 6, 7)]
    # a chunk's rows (clients 2..6 of 10) with a leaf that is no tensor
    chunk = plan.shard_batch((rows[2:7], None), slice(2, 7), 10)
    assert [(r, p.start, p.stop) for r, p, _ in chunk] == [(0, 2, 3), (1, 3, 6), (2, 6, 7)]
    assert [x[:, 0].tolist() for _, _, (x, _) in chunk] == [[2.0], [3.0, 4.0, 5.0], [6.0]]
    assert all(none is None for _, _, (_, none) in chunk)


def test_make_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("n,k", [(8, 16), (8, 10), (8, 7), (4, 6), (1, 5), (6, 9)])
def test_auto_mesh_shape_matches_jax(n, k):
    assert auto_mesh_shape(n, k) == jax_auto_mesh_shape(n, k)


def _jobs(ranks=1, per=8):
    return [(r, torch.device("cuda", r * per + i)) for r in range(ranks) for i in range(per)]


@pytest.mark.parametrize("kw", [{}, {"mesh_shape": (4, 2)},
                                {"mesh_shape": (2, 2), "dcn_mesh_shape": (2, 1)},
                                {"dcn_mesh_shape": (2, 1)},
                                {"mesh_shape": (1, 2), "dcn_mesh_shape": (2, 2)}],
                         ids=["default", "4x2", "hybrid2x2", "hybrid-default", "hybrid1x2"])
def test_make_global_mesh_matches_jax(kw):
    jmesh = jax_dist.make_global_mesh(**kw)
    mesh = dist.make_global_mesh(devices=_jobs(), **kw)
    assert mesh.shape == dict(jmesh.shape)
    assert _indices(mesh) == _ids(jmesh)
    assert (mesh.ranks == 0).all()


def test_make_global_mesh_errors_match_jax():
    for kw in ({"mesh_shape": (3, 2)}, {"mesh_shape": (3, 2), "dcn_mesh_shape": (2, 1)}):
        with pytest.raises(ValueError, match="devices"):
            jax_dist.make_global_mesh(**kw)
        with pytest.raises(ValueError, match="devices"):
            dist.make_global_mesh(devices=_jobs(), **kw)


def test_host_client_slice_matches_jax():
    jmesh = jax_dist.make_global_mesh()
    mesh = dist.make_global_mesh(devices=_jobs())
    assert dist.host_client_slice(16, mesh) == jax_dist.host_client_slice(16, jmesh) == (0, 16)
    for fn, m in ((jax_dist.host_client_slice, jmesh), (dist.host_client_slice, mesh)):
        with pytest.raises(ValueError, match="not divisible by 8 client shards"):
            fn(9, m)
    # two ranks of 4 entries each, rank-major: rank 1 owns the back half
    two = dist.make_global_mesh(devices=_jobs(2, 4))
    assert [dist.host_client_slice(16, two, rank=r) for r in (0, 1)] == [(0, 8), (8, 16)]
    hybrid = dist.make_global_mesh(mesh_shape=(2, 2), dcn_mesh_shape=(2, 1),
                                   devices=_jobs(2, 4))
    assert dist.host_client_slice(16, hybrid, rank=1) == (8, 16)
    # a rank whose rows are not adjacent has no single range
    odd = dist.make_global_mesh(devices=[(r % 2, torch.device("cpu")) for r in range(4)])
    with pytest.raises(ValueError, match="non-contiguous"):
        dist.host_client_slice(8, odd, rank=0)


def test_global_client_array_and_single_process_calls():
    dist.initialize()  # no job in the environment: a no-op
    dist.sync_global_devices("test")
    assert dist.is_coordinator() and dist.world_size() == 1
    plan = make_plan(dist.make_global_mesh(local_devices=CPU8))
    rows = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = dist.make_global_client_array(rows, 16, plan)
    assert arr.shape == (16, 3) and (arr.lo, arr.hi) == (0, 16)
    np.testing.assert_array_equal(arr[slice(4, 9)].numpy(), rows[4:9])
    with pytest.raises(IndexError):
        dist.GlobalClientArray(arr.local[:8], 0, 8, 16)[slice(6, 10)]


# -- the sharded round -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _batch(seed=1):
    r = np.random.RandomState(seed)
    return (r.randn(K, S, B, 28, 28, 1).astype(np.float32),
            r.randint(0, 10, (K, S, B)).astype(np.int32))


def _port_engine(jax_params, plan=None, attack=None, **kw):
    spec = create_mnist_model()
    params = params_from_jax(jax_params, spec.layout)
    eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                      num_clients=K, num_byzantine=F,
                      attack=attack or get_attack("alie", num_clients=K, num_byzantine=F),
                      aggregator=get_aggregator("trimmedmean", num_byzantine=F),
                      keep_updates=True, device="cpu", plan=plan, **kw)
    return eng, params


def _port_round(jax_params, plan=None, seed=1, **kw):
    eng, params = _port_engine(jax_params, plan, **kw)
    cx, cy = _batch(seed)
    state, m = eng.run_round(eng.init(params), torch.from_numpy(cx), torch.from_numpy(cy),
                             0.1, 1.0, seed=0)
    return eng, state, m


def _assert_round(a, b):
    (ea, sa, ma), (eb, sb, mb) = a, b
    np.testing.assert_allclose(ea.last_updates.numpy(), eb.last_updates.numpy(), **ROWS_TOL)
    np.testing.assert_allclose(float(ma.agg_norm), float(mb.agg_norm), rtol=1e-4)
    np.testing.assert_allclose(ravel(sa.params, ea.layout).numpy(),
                               ravel(sb.params, eb.layout).numpy(), **PARAMS_TOL)


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_round_matches_unsharded_and_jax(jax_params, shape, chunks):
    plan = make_plan(make_mesh(CPU8, shape))
    sharded = _port_round(jax_params, plan, client_chunks=chunks)
    _assert_round(sharded, _port_round(jax_params, client_chunks=chunks))
    # JAX's sharded round on its (c, m) mesh of the 8 host devices
    jplan = jax_make_plan(jax_make_mesh(jax.devices(), shape))
    jspec = jax_mlp()
    jeng = JaxRoundEngine(jspec.train_loss_fn, jspec.eval_logits_fn, jax_params,
                          num_clients=K, num_byzantine=F,
                          attack=jax_get_attack("alie", num_clients=K, num_byzantine=F),
                          aggregator=jax_get_aggregator("trimmedmean", num_byzantine=F),
                          plan=jplan, keep_updates=True, client_chunks=chunks)
    cx, cy = _batch()
    jstate, jm = jeng.run_round(jeng.init(jax_params), jnp.asarray(cx), jnp.asarray(cy),
                                0.1, 1.0, jax.random.PRNGKey(2))
    eng, state, m = sharded
    np.testing.assert_allclose(eng.last_updates.numpy(), np.asarray(jeng.last_updates),
                               **ROWS_TOL)
    np.testing.assert_allclose(float(m.agg_norm), float(jm.agg_norm), rtol=1e-4)
    np.testing.assert_allclose(ravel(state.params, eng.layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **PARAMS_TOL)


def test_model_axis_aggregates_in_column_blocks(jax_params, monkeypatch):
    """(2, 4): the trimmed mean runs once per model-axis column block, on
    ``[K, ceil(D/4)]`` then ``[K, floor(D/4)]`` blocks; without the kernel
    route (b=0) and under diagnostics it runs whole."""
    from blades_tpu_torch.aggregators.trimmedmean import Trimmedmean

    seen = []
    orig = Trimmedmean.aggregate

    def spy(self, updates, state=(), **ctx):
        seen.append(tuple(updates.shape))
        return orig(self, updates, state, **ctx)

    monkeypatch.setattr(Trimmedmean, "aggregate", spy)
    plan = make_plan(make_mesh(CPU8, (2, 4)))
    eng, _, _ = _port_round(jax_params, plan)
    d = eng.dim
    assert seen == [(K, -(-d // 4))] * (d % 4) + [(K, d // 4)] * (4 - d % 4)
    seen.clear()
    _port_round(jax_params, plan, collect_diagnostics=True)
    assert seen == [(K, d)]
    assert not Trimmedmean(num_byzantine=0).column_separable(K)
    assert not get_aggregator("median").column_separable(K)


def test_sharded_streaming_and_async_match_unsharded(jax_params):
    plan = make_plan(make_mesh(CPU8, (4, 2)))
    for kw in (dict(streaming=True, client_chunks=3, attack=get_attack("signflipping")),
               dict(async_config=AsyncConfig(buffer_m=4, arrivals=ArrivalProcess(
                   kind="uniform", max_delay=2), staleness="polynomial")),
               dict(async_config=AsyncConfig(buffer_m=K))):
        outs = []
        for p in (None, plan):
            eng, params = _port_engine(jax_params, p, **kw)
            state = eng.init(params)
            for rnd in range(3):
                cx, cy = _batch(10 + rnd)
                state, m = eng.run_round(state, torch.from_numpy(cx), torch.from_numpy(cy),
                                         0.1, 1.0, seed=4)
            outs.append((ravel(state.params, eng.layout).numpy(), float(m.agg_norm)))
        np.testing.assert_allclose(outs[1][0], outs[0][0], **PARAMS_TOL)
        np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-4)


def test_named_device_is_the_mesh_primary(jax_params, tmp_path, monkeypatch):
    """A device that names an entry must be the mesh's primary one: the
    engine and the Simulator raise otherwise, and the Simulator builds no
    mesh unasked for a device that names a card (two cards faked here; each
    construction stops where the store would go to its device)."""
    plan = make_plan(make_mesh(CPU8, (2, 4)))
    spec = create_mnist_model()
    params = params_from_jax(jax_params, spec.layout)
    with pytest.raises(ValueError, match="not the plan's primary device"):
        RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                    num_clients=K, device="cuda:1", plan=plan)
    assert _port_engine(jax_params, plan)[0].device == torch.device("cpu")

    class Reached(Exception):
        pass

    def get_dls(self, device):
        raise Reached(torch.device(device))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(Synthetic, "get_dls", get_dls)
    ds = Synthetic(num_clients=4, train_size=100, cache=False)
    kw = dict(log_path=str(tmp_path))
    for device, want in [("cuda:1", torch.device("cuda", 1)), (None, torch.device("cuda", 0)),
                         ("cuda", torch.device("cuda", 0))]:
        with pytest.raises(Reached) as hit:
            Simulator(ds, device=device, **kw)
        assert hit.value.args[0] == want, device
    with pytest.raises(ValueError, match=r"!= 1 devices"):
        Simulator(ds, device="cuda:1", mesh_shape=(2, 1), **kw)
    with pytest.raises(ValueError, match="not the mesh's primary entry"):
        Simulator(ds, device="cuda:1", mesh_shape=(1, 1),
                  mesh_devices=[torch.device("cuda", 0)], **kw)


# -- the Simulator ----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_simulator_mesh_matches_jax(tmp_path, monkeypatch, shape):
    """Three rounds of ``Simulator(mesh_shape=...)`` of both packages: the
    port takes the JAX run's init (recorded at its ``engine.init``), and
    both samplers hand out the same numpy batches, round by round."""
    batches = [_batch(20 + r) for r in range(3)]
    calls = {"jax": 0, "port": 0}

    def jax_sample(self, key, local_steps, batch_size):
        calls["jax"] += 1
        return tuple(map(jnp.asarray, batches[calls["jax"] - 1]))

    def port_sample(self, generator, local_steps, batch_size):
        calls["port"] += 1
        return tuple(map(torch.from_numpy, batches[calls["port"] - 1]))

    init = {}
    orig_init = JaxRoundEngine.init

    def record_init(self, params):
        init["params"] = jax.tree_util.tree_map(np.asarray, params)
        return orig_init(self, params)

    monkeypatch.setattr(JaxFLDataset, "sample_round", jax_sample)
    monkeypatch.setattr(FLDataset, "sample_round", port_sample)
    monkeypatch.setattr(JaxRoundEngine, "init", record_init)
    orig_port_init = RoundEngine.init
    monkeypatch.setattr(RoundEngine, "init", lambda self, params: orig_port_init(
        self, params_from_jax(init["params"], self.layout)))

    data = dict(num_clients=K, train_size=400, test_size=80, cache=False)
    sim_kw = dict(attack="alie", num_byzantine=F, aggregator="trimmedmean",
                  aggregator_kws={"num_byzantine": F}, seed=1, mesh_shape=shape)
    run = dict(global_rounds=3, local_steps=S, train_batch_size=B, validate_interval=3)
    ref = JaxSimulator(JaxSynthetic(**data), log_path=str(tmp_path / "jax"), **sim_kw)
    ref.run(model="mlp", **run)
    sim = Simulator(Synthetic(**data), log_path=str(tmp_path / "port"), device="cpu",
                    mesh_devices=CPU8, **sim_kw)
    sim.run(model="mlp", **run)
    assert calls == {"jax": 3, "port": 3}
    assert sim.plan.mesh.shape == dict(ref.plan.clients.mesh.shape)
    assert sim.engine.plan is sim.plan
    np.testing.assert_allclose(ravel(sim.server.state.params, sim.engine.layout).numpy(),
                               np.asarray(ravel_pytree(ref.server.state.params)[0]),
                               rtol=1e-4, atol=1e-6)


def test_simulator_mesh_options(tmp_path):
    ds = Synthetic(num_clients=4, train_size=100, cache=False)
    with pytest.raises(ValueError, match="mesh_devices needs mesh_shape"):
        Simulator(ds, device="cpu", log_path=str(tmp_path), mesh_devices=CPU8[:4])
    with pytest.raises(ValueError, match=r"!= 4 devices"):
        Simulator(ds, device="cpu", log_path=str(tmp_path), mesh_shape=(3, 1),
                  mesh_devices=CPU8[:4])
    sim = Simulator(ds, device="cpu", log_path=str(tmp_path), mesh_shape=(2, 2),
                    mesh_devices=CPU8[:4])
    assert sim.device == torch.device("cpu") and sim.plan.model_width == 2
    # no mesh asked on the CPU: no plan
    assert Simulator(ds, device="cpu", log_path=str(tmp_path)).plan is None


def test_engine_cache_key_tells_meshes_apart(tmp_path):
    cache = EngineCache()
    data = dict(num_clients=8, train_size=200, test_size=40, cache=False)
    engines = []
    for shape in [(2, 4), (2, 4), (4, 2), None]:
        kw = {} if shape is None else dict(mesh_shape=shape, mesh_devices=CPU8)
        sim = Simulator(Synthetic(**data), aggregator="trimmedmean", device="cpu",
                        log_path=str(tmp_path), **kw)
        sim.run(model="mlp", global_rounds=1, train_batch_size=4, engine_cache=cache)
        engines.append(sim.engine)
    assert engines[0] is engines[1]
    assert len({id(e) for e in engines}) == 3 and len(cache) == 3
    assert engines[2].plan.mesh.shape == {"clients": 4, "model": 2}
    assert engines[3].plan is None
