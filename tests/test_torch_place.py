"""``FLDataset.place`` (``blades_tpu_torch/datasets/fl.py``) against the
JAX package's (``blades_tpu/datasets/fl.py:110-145``) on the conftest's
8-device CPU mesh, and the placed store's batches and rounds against the
unplaced ones.

The port's meshes are virtual: 8 entries of the CPU, so a piece "on its
row's device" is on the CPU, and placement is checked by the rows each
piece holds and the device it names. Tolerances: the placed batches, the
placed rounds' params and the samplers' generator states equal the
unplaced ones bit for bit (``torch.equal``); the placed ``(4, 2)`` run
against the JAX Simulator's placed run, both sampling from the same order
draws (JAX's ``u``, handed to the port's ``torch.rand``), at the bars of
``tests/test_torch_parallel.py``'s Simulator case (params ``rtol=1e-4,
atol=1e-6``). A store placed for a job mesh is stood in for by a plan
whose mesh gives rank 0 half of the rows (``collective`` patched true);
the real two-rank job is ``tests/test_torch_distributed.py``, and the
captured round on a placed store ``tests/test_torch_blocks.py`` (its card
form needs a file that does not import JAX).
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from blades_tpu import Simulator as JaxSimulator
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.datasets import Synthetic as JaxSynthetic
from blades_tpu.datasets.fl import FLDataset as JaxFLDataset
from blades_tpu_torch import Simulator
from blades_tpu_torch.core import RoundEngine
from blades_tpu_torch.datasets import CIFAR10, Synthetic, SyntheticText, augment
from blades_tpu_torch.datasets.fl import FLDataset
from blades_tpu_torch.models import params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.parallel import Mesh, ShardingPlan, make_mesh, make_plan
from blades_tpu_torch.parallel.mesh import GlobalClientArray
from blades_tpu_torch.telemetry import programs
from test_torch_data import _write_cifar10
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

K, S, B = 8, 2, 3
CPU8 = [torch.device("cpu")] * 8
SHAPES = [(8, 1), (4, 2), (2, 4)]
PARAMS_TOL = dict(rtol=1e-4, atol=1e-6)


def _gen(seed=5):
    return torch.Generator().manual_seed(seed)


def _copy(fl: FLDataset) -> FLDataset:
    """A fresh unplaced store with ``fl``'s arrays, transform and
    normalizer."""
    return FLDataset(fl.train_x.numpy(), fl.train_y.numpy(), fl.train_counts.numpy(),
                     fl.test_x_raw.numpy(), fl.test_y.numpy(), transform=fl.transform,
                     normalize=fl.normalize, pad_id=fl.pad_id, test_counts=fl.test_counts)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The three stores of the placed-against-unplaced test, unplaced:
    float32 Synthetic without a transform, CIFAR-10 files (uint8, the
    crop/flip/erasing transform and the normalizer), and SyntheticText
    (int32 tokens)."""
    root = tmp_path_factory.mktemp("cifar")
    _write_cifar10(str(root))
    cifar = CIFAR10(data_root=str(root), num_clients=K, iid=False, alpha=0.5,
                    cache=False).get_dls("cpu")
    assert cifar.transform is augment.cifar_train_transform and cifar.normalize is not None
    return {
        "synthetic": Synthetic(num_clients=K, train_size=96, test_size=16,
                               cache=False).get_dls("cpu"),
        "cifar10_files": cifar,
        "text": SyntheticText(num_clients=K, vocab_size=40, seq_len=8, train_size=120,
                              test_size=16, cache=False).get_dls("cpu"),
    }


# -- the layout, beside the JAX test ------------------------------------------------


def test_place_lays_the_store_and_batches_over_clients_like_jax():
    """The counterpart of ``tests/test_datasets.py:196``: K=8 clients of 12
    ``4x4x1`` samples on an ``(8, 1)`` mesh, the JAX test's calls beside
    the port's."""
    k, n = 8, 12
    r = np.random.RandomState(0)
    xs = [r.rand(n, 4, 4, 1).astype(np.float32) for _ in range(k)]
    ys = [r.randint(0, 3, n).astype(np.int32) for _ in range(k)]
    jfl = JaxFLDataset.from_client_arrays(xs, ys, xs[0][:2], ys[0][:2])
    jmesh = JaxMesh(np.array(jax.devices()).reshape(8, 1), ("clients", "model"))
    sharding = NamedSharding(jmesh, P("clients"))
    jfl.place(sharding)
    assert jfl.train_x.sharding.is_equivalent_to(sharding, jfl.train_x.ndim)
    jcx, jcy = jfl.sample_round(jax.random.PRNGKey(0), 2, 4)
    assert jcx.shape == (k, 2, 4, 4, 4, 1)
    assert jcx.sharding.is_equivalent_to(sharding, jcx.ndim)
    assert jcy.sharding.is_equivalent_to(sharding, jcy.ndim)

    fl = FLDataset.from_client_arrays(xs, ys, xs[0][:2], ys[0][:2])
    plan = make_plan(make_mesh(CPU8, (8, 1)))
    assert fl.place(plan) is fl and fl.placed and fl.place_skipped is None
    cx, cy = fl.sample_round(_gen(), 2, 4)
    assert isinstance(cx, GlobalClientArray) and isinstance(cy, GlobalClientArray)
    assert cx.shape == tuple(jcx.shape) and cy.shape == tuple(jcy.shape)
    for name in ("train_x", "train_y", "train_counts"):
        arr = getattr(fl, name)
        assert arr.shape[0] == k and (arr.lo, arr.hi) == (0, k)
    # each row's store piece and batch piece: its one client, on its device,
    # the rows JAX's shard of that device holds
    shards = {s.index[0].start: np.asarray(s.data) for s in jfl.train_x.addressable_shards}
    for row in range(k):
        dev = plan.row_device(row)
        for arr in (fl.train_x, fl.train_y, fl.train_counts, cx, cy):
            assert arr.starts[row: row + 2] == [row, row + 1]
            assert arr.pieces[row].device == dev
        np.testing.assert_array_equal(fl.train_x.pieces[row].numpy(), shards[row])
        np.testing.assert_array_equal(fl.train_x[row].numpy(), xs[row])
    # the test set stays whole, as JAX places the train arrays only
    assert isinstance(fl.test_x_raw, torch.Tensor) and fl.test_x_raw.shape[0] == 2


# -- placed against unplaced, bit for bit ---------------------------------------------


@pytest.mark.parametrize("entry", ["sample_round", "sampler"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("store", ["synthetic", "cifar10_files", "text"])
def test_placed_batches_equal_unplaced(stores, store, shape, entry):
    """The placed sampler's batches equal the unplaced sampler's bit for
    bit from the same generator state, and it leaves the generator where
    the unplaced one does (the same draws, in the same order)."""
    base = stores[store]
    plain, placed = _copy(base), _copy(base)
    plan = make_plan(make_mesh(CPU8, shape))
    placed.place(plan)
    assert placed.placed and not plain.placed

    def draw(fl, gen):
        if entry == "sample_round":
            return fl.sample_round(gen, S, B)
        return fl.sampler(S, B)(gen)

    g_plain, g_placed = _gen(), _gen()
    cx, cy = draw(plain, g_plain)
    px, py = draw(placed, g_placed)
    assert torch.equal(g_plain.get_state(), g_placed.get_state())
    rows = plan.row_ranges(K)
    for got, want in ((px, cx), (py, cy)):
        assert isinstance(got, GlobalClientArray) and got.shape == want.shape
        assert got.dtype == want.dtype
        assert [(a, b) for a, b in zip(got.starts, got.starts[1:])] == [
            (r.start, r.stop) for r in rows]
        for r, rng in enumerate(rows):
            assert got.pieces[r].device == plan.row_device(r)
            assert torch.equal(got[rng], want[rng])
        assert torch.equal(got.local, want)
    if store == "cifar10_files":  # the transform ran: augmented, normalized floats
        assert px.dtype == torch.float32


def test_placed_get_train_data_equals_unplaced(stores):
    base = stores["cifar10_files"]
    plain, placed = _copy(base), _copy(base)
    placed.place(make_plan(make_mesh(CPU8, (4, 2))))
    for cid in (0, 5):
        for (x, y), (px, py) in zip(plain.get_train_data(cid, 3, 4),
                                    placed.get_train_data(cid, 3, 4)):
            assert torch.equal(x, px) and torch.equal(y, py)


# -- the no-op cases, held to JAX's ------------------------------------------------------


def _jax_uneven(k):
    r = np.random.RandomState(1)
    xs = [r.rand(6, 4, 4, 1).astype(np.float32) for _ in range(k)]
    ys = [r.randint(0, 3, 6).astype(np.int32) for _ in range(k)]
    return xs, ys


def test_place_uneven_k_is_a_noop_as_in_jax():
    """K=10 over 4 clients-axis rows: JAX's ``device_put`` raises and
    ``place`` keeps the default layout; the port keeps the store whole on
    the primary device, its sampler included, and says why."""
    xs, ys = _jax_uneven(10)
    jfl = JaxFLDataset.from_client_arrays(xs, ys, xs[0][:2], ys[0][:2])
    jmesh = JaxMesh(np.array(jax.devices()).reshape(4, 2), ("clients", "model"))
    jfl.place(NamedSharding(jmesh, P("clients")))
    assert jfl._sharding is None

    fl = FLDataset.from_client_arrays(xs, ys, xs[0][:2], ys[0][:2])
    before = fl.sampler(2, 4)
    fl.place(make_plan(make_mesh(CPU8, (4, 2))))
    assert not fl.placed and "K=10 is not divisible by the 4" in fl.place_skipped
    assert isinstance(fl.train_x, torch.Tensor) and fl.sampler(2, 4) is before
    cx, _ = fl.sample_round(_gen(), 2, 4)
    assert isinstance(cx, torch.Tensor) and cx.shape == (10, 2, 4, 4, 4, 1)


def test_place_same_layout_twice_keeps_the_samplers_as_in_jax():
    """Placing again in the same layout is a no-op in both packages: JAX
    keeps its sampler jits, the port its sampler objects, and no new
    ``dataset/sample_round`` build is recorded; another layout makes a new
    sampler."""
    xs, ys = _jax_uneven(8)
    jfl = JaxFLDataset.from_client_arrays(xs, ys, xs[0][:2], ys[0][:2])
    jmesh = JaxMesh(np.array(jax.devices()).reshape(8, 1), ("clients", "model"))
    jfl.place(NamedSharding(jmesh, P("clients")))
    jfl.sample_round(jax.random.PRNGKey(0), 2, 4)
    jit = dict(jfl._sample_jit)
    jfl.place(NamedSharding(jmesh, P("clients")))
    assert jfl._sample_jit == jit and len(jit) == 1

    fl = FLDataset.from_client_arrays(xs, ys, xs[0][:2], ys[0][:2])
    fl.place(make_plan(make_mesh(CPU8, (8, 1))))
    fl.sample_round(_gen(), 2, 4)
    sampler, store = fl.sampler(2, 4), fl.train_x
    seen = len(programs.events())
    fl.place(make_plan(make_mesh(CPU8, (8, 1))))  # a new plan, the same layout
    assert fl.sampler(2, 4) is sampler and fl.train_x is store
    fl.sample_round(_gen(), 2, 4)
    assert not [e for e in programs.events()[seen:]
                if e.get("label") == "dataset/sample_round" and e.get("outcome") != "warm-reuse"]
    fl.place(make_plan(make_mesh(CPU8, (2, 4))))
    assert fl.sampler(2, 4) is not sampler and len(fl.train_x.pieces) == 2


def test_place_with_an_opaque_transform_is_a_noop(stores):
    """A transform with no split form (``draw`` / ``apply``) draws over the
    whole batch: ``place`` leaves the store whole and says why, and the
    batches are the unplaced ones."""
    base = stores["cifar10_files"]
    plain, fl = _copy(base), _copy(base)
    opaque = lambda x, g: augment.cifar_train_transform(x, g)  # noqa: E731
    plain.transform = fl.transform = opaque
    fl.place(make_plan(make_mesh(CPU8, (4, 2))))
    assert not fl.placed and "has no split form" in fl.place_skipped
    cx, cy = plain.sample_round(_gen(), S, B)
    px, py = fl.sample_round(_gen(), S, B)
    assert torch.equal(cx, px) and torch.equal(cy, py)


def test_to_unplaces_and_a_job_mesh_store_refuses(stores, monkeypatch):
    """``to`` gathers a placed store whole (its sampler a new, unplaced
    one); a store placed for a job mesh holds only its rank's rows, samples
    them alone, and refuses to be gathered."""
    base = stores["synthetic"]
    plain, fl = _copy(base), _copy(base)
    fl.place(make_plan(make_mesh(CPU8, (4, 2))))
    placed_sampler = fl.sampler(S, B)
    assert fl.to("cpu") is fl and not fl.placed
    assert isinstance(fl.train_x, torch.Tensor) and torch.equal(fl.train_x, plain.train_x)
    assert fl.sampler(S, B) is not placed_sampler
    cx, _ = fl.sample_round(_gen(), S, B)
    assert isinstance(cx, torch.Tensor) and torch.equal(cx, plain.sample_round(_gen(), S, B)[0])

    # rank 0 of a two-process (4, 2) mesh: rows 0 and 1 are its own
    monkeypatch.setattr(ShardingPlan, "collective", property(lambda self: True))
    devices = np.array(CPU8, dtype=object).reshape(4, 2)
    ranks = np.array([[0, 0], [0, 0], [1, 1], [1, 1]])
    job = ShardingPlan(Mesh(devices, ("clients", "model"), ranks=ranks))
    fl.place(job)
    assert fl.placed and (fl.train_x.lo, fl.train_x.hi) == (0, K // 2)
    assert [int(p.shape[0]) for p in fl.train_x.pieces] == [2, 2]
    # its own storage: the whole store is not kept alive through a view
    whole = plain.train_x.untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() != whole for p in fl.train_x.pieces)
    px, py = fl.sample_round(_gen(), S, B)
    want_x, want_y = plain.sample_round(_gen(), S, B)
    assert (px.lo, px.hi) == (0, K // 2)
    assert torch.equal(px.local, want_x[: K // 2]) and torch.equal(py.local, want_y[: K // 2])
    with pytest.raises(ValueError, match="cannot be gathered"):
        fl.to("cpu")


# -- whole rounds ---------------------------------------------------------------------


def _sim_run(tmp_path, name, mesh, path, rounds=3):
    """``rounds`` rounds of the MLP (ALIE, or sign flipping on the
    streaming path, + trimmed mean) on a K=8 Synthetic store, in 3 client
    chunks: the chunk of clients 3-5 cuts across the two rows of a
    ``(2, 4)`` mesh, so its parts come from two pieces of a placed batch."""
    streaming = path == "streaming"
    ds = Synthetic(num_clients=K, train_size=400, test_size=80, cache=False)
    sim = Simulator(ds, attack="signflipping" if streaming else "alie", num_byzantine=2,
                    aggregator="trimmedmean", aggregator_kws={"num_byzantine": 2}, seed=1,
                    device="cpu", log_path=str(tmp_path / name),
                    **({} if mesh is None else dict(mesh_shape=mesh, mesh_devices=CPU8)))
    run = dict(global_rounds=rounds, local_steps=S, train_batch_size=B,
               validate_interval=rounds)
    if path == "run_block":
        run["block_size"] = rounds
    sim.run(model="mlp", client_chunks=3, streaming=streaming, **run)
    return sim


@pytest.mark.parametrize("path", ["eager", "run_block", "streaming"])
def test_placed_mesh_run_equals_unsharded_bit_for_bit(tmp_path, monkeypatch, path):
    """``Simulator(mesh_shape=(2, 4), mesh_devices=CPU8)`` places its store
    and trains each row's part of the placed batch where it lies; over 3
    rounds its params equal the unsharded run's bit for bit."""
    ref = _sim_run(tmp_path, "plain", None, path)
    assert not ref.dataset.placed
    seen = {"batches": 0, "pieces": set(), "read": []}
    orig_round, orig_part = RoundEngine._round, RoundEngine._train_part

    def spy_round(self, state, batch, inputs, streams):
        if self.plan is not None:
            assert all(isinstance(t, GlobalClientArray) for t in batch)
            seen["batches"] += 1
            seen["pieces"] |= {p.untyped_storage().data_ptr() for p in batch[0].pieces}
        return orig_round(self, state, batch, inputs, streams)

    def spy_part(self, params, flat0, client_lr, cx, *args, **kw):
        if self.plan is not None:
            seen["read"].append(cx.untyped_storage().data_ptr())
        return orig_part(self, params, flat0, client_lr, cx, *args, **kw)

    monkeypatch.setattr(RoundEngine, "_round", spy_round)
    monkeypatch.setattr(RoundEngine, "_train_part", spy_part)
    sim = _sim_run(tmp_path, "mesh", (2, 4), path)
    assert sim.dataset.placed and len(sim.dataset.train_x.pieces) == 2
    assert seen["batches"] == 3
    # every part trained on a view of its row's piece: no copy
    assert seen["read"] and set(seen["read"]) <= seen["pieces"]
    got = ravel(sim.server.state.params, sim.engine.layout)
    want = ravel(ref.server.state.params, ref.engine.layout)
    assert torch.equal(got, want), float((got - want).abs().max())


def test_simulator_replaces_and_unplaces_a_shared_store(tmp_path):
    """One store handed to Simulators in turn: placed in each mesh's
    layout, kept (with its sampler) for the same layout, gathered whole
    for a Simulator with no mesh."""
    ds = Synthetic(num_clients=K, train_size=200, test_size=40, cache=False)
    fl = ds.get_dls("cpu")
    kw = dict(device="cpu", log_path=str(tmp_path))
    Simulator(fl, mesh_shape=(4, 2), mesh_devices=CPU8, **kw)
    assert fl.placed and len(fl.train_x.pieces) == 4
    sampler = fl.sampler(S, B)
    Simulator(fl, mesh_shape=(4, 2), mesh_devices=CPU8, **kw)
    assert fl.sampler(S, B) is sampler
    Simulator(fl, mesh_shape=(2, 4), mesh_devices=CPU8, **kw)
    assert fl.placed and len(fl.train_x.pieces) == 2 and fl.sampler(S, B) is not sampler
    sim = Simulator(fl, **kw)
    assert not fl.placed and isinstance(fl.train_x, torch.Tensor)
    # a BaseDataset's cached store goes the same way
    Simulator(ds, mesh_shape=(8, 1), mesh_devices=CPU8, **kw)
    assert ds.get_dls("cpu").placed
    assert not Simulator(ds, **kw).dataset.placed
    assert sim.dataset is fl


def test_placed_run_matches_jax_placed_run(tmp_path, monkeypatch):
    """Three rounds of both packages' Simulators on a ``(4, 2)`` mesh, each
    store placed, each sampler real: the JAX sampler's order draws ``u``
    (from its round key) are handed to the port's placed sampler, and the
    port takes the JAX run's init."""
    us, init = [], {}
    orig_sample = JaxFLDataset.sample_round

    def jax_sample(self, key, local_steps, batch_size):
        n_max = int(self.train_x.shape[1])
        us.append(np.asarray(jax.random.uniform(jax.random.split(key)[0],
                                                (self.num_clients, n_max))))
        return orig_sample(self, key, local_steps, batch_size)

    orig_init = JaxRoundEngine.init

    def record_init(self, params):
        init["params"] = jax.tree_util.tree_map(np.asarray, params)
        return orig_init(self, params)

    monkeypatch.setattr(JaxFLDataset, "sample_round", jax_sample)
    monkeypatch.setattr(JaxRoundEngine, "init", record_init)
    data = dict(num_clients=K, train_size=400, test_size=80, cache=False)
    sim_kw = dict(attack="alie", num_byzantine=2, aggregator="trimmedmean",
                  aggregator_kws={"num_byzantine": 2}, seed=1, mesh_shape=(4, 2))
    run = dict(model="mlp", global_rounds=3, local_steps=S, train_batch_size=B,
               validate_interval=3)
    ref = JaxSimulator(JaxSynthetic(**data), log_path=str(tmp_path / "jax"), **sim_kw)
    assert ref.dataset._sharding is not None
    ref.run(**run)
    assert len(us) == 3

    real_rand = torch.rand
    queue = list(us)

    def rand(*shape, **kw):
        if tuple(shape[0]) == us[0].shape:
            return torch.from_numpy(np.array(queue.pop(0))).to(kw.get("device"))
        return real_rand(*shape, **kw)

    orig_port_init = RoundEngine.init
    monkeypatch.setattr(RoundEngine, "init", lambda self, params: orig_port_init(
        self, params_from_jax(init["params"], self.layout)))
    sim = Simulator(Synthetic(**data), log_path=str(tmp_path / "port"), device="cpu",
                    mesh_devices=CPU8, **sim_kw)
    assert sim.dataset.placed
    np.testing.assert_array_equal(sim.dataset.train_x.local.numpy(),
                                  np.asarray(ref.dataset.train_x))
    monkeypatch.setattr(torch, "rand", rand)
    sim.run(**run)
    assert not queue
    np.testing.assert_allclose(ravel(sim.server.state.params, sim.engine.layout).numpy(),
                               np.asarray(ravel_pytree(ref.server.state.params)[0]),
                               **PARAMS_TOL)
