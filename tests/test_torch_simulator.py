"""The port's data path and Simulator facade against the JAX package's.

Datasets are built with ``cache=False`` (or a ``tmp_path`` data root), so no
partition archive lands in the repository.
"""

import os

import numpy as np
import pytest
import torch

from blades_tpu import Simulator as JaxSimulator
from blades_tpu.datasets import Synthetic as JaxSynthetic
from blades_tpu.utils.logging import read_stats as jax_read_stats
from blades_tpu_torch import Simulator
from blades_tpu_torch.client import ByzantineClient
from blades_tpu_torch.core import ClientOptSpec
from blades_tpu_torch.datasets import FLDataset, Synthetic
from blades_tpu_torch.utils.logging import read_stats
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("iid", [True, False])
def test_partition_matches_jax(iid):
    kw = dict(num_clients=7, train_size=500, test_size=90, iid=iid, alpha=0.5,
              seed=3, cache=False)
    ours = Synthetic(**kw).get_dls("cpu")
    ref = JaxSynthetic(**kw).get_dls()
    np.testing.assert_array_equal(ours.train_counts.numpy(), np.asarray(ref.train_counts))
    np.testing.assert_array_equal(ours.train_x.numpy(), np.asarray(ref.train_x))
    np.testing.assert_array_equal(ours.train_y.numpy(), np.asarray(ref.train_y))
    np.testing.assert_array_equal(ours.test_x.numpy(), np.asarray(ref.test_x))
    np.testing.assert_array_equal(ours.test_y.numpy(), np.asarray(ref.test_y))
    for a, b in zip(ours.client_test_slices(), ref.client_test_slices()):
        np.testing.assert_array_equal(a, b)


def test_partition_cache_round_trip(tmp_path):
    kw = dict(num_clients=5, train_size=200, test_size=50, seed=1, data_root=str(tmp_path))
    first = Synthetic(**kw).get_dls("cpu")
    assert len(os.listdir(tmp_path)) == 1
    again = Synthetic(**kw).get_dls("cpu")  # read back from the archive
    np.testing.assert_array_equal(first.train_x.numpy(), again.train_x.numpy())
    np.testing.assert_array_equal(first.test_y.numpy(), again.test_y.numpy())


def test_sample_round_wraps_and_skips_padding():
    k, n_max = 3, 6
    counts = np.array([2, 6, 5])
    x = np.arange(k * n_max, dtype=np.float32).reshape(k, n_max, 1)
    y = np.tile(np.arange(n_max), (k, 1))
    ds = FLDataset(x, y, counts, np.zeros((3, 1), np.float32), np.zeros(3, np.int64))
    cx, cy = ds.sample_round(torch.Generator().manual_seed(0), local_steps=2, batch_size=4)
    assert cx.shape == (k, 2, 4, 1) and cy.shape == (k, 2, 4)
    for i, c in enumerate(counts):
        drawn = cy[i].reshape(-1).tolist()
        assert max(drawn) < c  # padding rows are never sampled
        # without replacement within an epoch, then the epoch wraps around
        assert sorted(drawn[:c]) == list(range(c))
        assert all(drawn[j] == drawn[j % c] for j in range(len(drawn)))


def _stats_shape(recs):
    return [(r["_meta"]["type"], sorted(r)) for r in recs]


def test_simulator_writes_jax_stats_records(tmp_path):
    # the mini example's shape: 10 clients, 4 ALIE attackers, MLP
    kw = dict(num_clients=10, train_size=600, test_size=100, cache=False)
    run = dict(global_rounds=2, local_steps=2, train_batch_size=8,
               server_lr=1.0, client_lr=0.1)
    sim = Simulator(Synthetic(**kw), attack="alie", num_byzantine=4,
                    aggregator="trimmedmean", seed=1, device="cpu",
                    log_path=str(tmp_path / "torch"))
    times = sim.run(model="mlp", **run)
    ref = JaxSimulator(JaxSynthetic(**kw), attack="alie", num_byzantine=4,
                       aggregator="trimmedmean", seed=1,
                       log_path=str(tmp_path / "jax"))
    ref.run(model="mlp", **run)

    ours = read_stats(str(tmp_path / "torch"))
    theirs = jax_read_stats(str(tmp_path / "jax"))
    assert _stats_shape(ours) == _stats_shape(theirs)
    assert len(times) == 2
    train = [r for r in ours if r["_meta"]["type"] == "train"]
    assert all(np.isfinite(r["Loss"]) for r in train)
    assert sim.engine.device == torch.device("cpu")
    # without a fault model the rounds are the dense ones
    assert sim.engine.fault_model is None and sim.engine.last_fault_diag is None
    assert sim.server.state.fault_state == ()


def test_unknown_kwarg_raises(tmp_path):
    with pytest.raises(RuntimeError, match="Unknown keyword"):
        Simulator(Synthetic(num_clients=4, cache=False), device="cpu",
                  log_path=str(tmp_path), bogus_flag=1)


def test_default_device_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = Synthetic(num_clients=4, train_size=100, cache=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(ds, log_path=str(tmp_path))
    assert ds._fl is None  # nothing was built on the CPU instead


@pytest.mark.parametrize(
    "option,value,slice_no",
    [
        ("collect_diagnostics", True, "slice 10"),
        ("audit_monitor", {}, "slice 10"),
        ("profile_dir", "prof", "slice 10"),
        ("remat", True, "slice 2b"),
        ("round_metrics", True, "slice 10"),
    ],
)
def test_every_jax_run_option_runs(tmp_path, option, value, slice_no):
    """Every run() option of the JAX Simulator is ported: ``remat`` (slice
    2b, since PR 14) runs and reaches the engine, and the options of slice
    10 run, each writing its surface; an unknown keyword still raises
    ``TypeError``."""
    sim = Simulator(Synthetic(num_clients=4, train_size=100, cache=False),
                    device="cpu", log_path=str(tmp_path))
    if slice_no != "slice 10":
        times = sim.run(model="mlp", **{option: value})
        assert len(times) == 1 and sim.engine.remat is True
        with pytest.raises(TypeError, match="unexpected keyword"):
            sim.run(model="mlp", rematerialize=True)
        return
    if option == "profile_dir":
        value = str(tmp_path / value)
    sim.run(model="mlp", **{option: value})
    assert {"collect_diagnostics": sim.engine.last_diagnostics,
            "audit_monitor": sim.engine.last_audit_diag,
            "round_metrics": sim.engine.last_metric_pack,
            "profile_dir": os.listdir(str(tmp_path / "prof"))
            if option == "profile_dir" else None}[option] is not None


def test_streaming_run_on_cpu(tmp_path):
    """``run(streaming=True)`` with a padded final chunk and a fault model:
    the engine streams, keeps no update matrix, and the records are the
    dense run's records."""
    kw = dict(num_clients=7, train_size=300, test_size=70, cache=False)
    run = dict(global_rounds=2, local_steps=2, train_batch_size=8, client_chunks=2)
    sim = Simulator(Synthetic(**kw), attack="signflipping", num_byzantine=2,
                    aggregator="trimmedmean", aggregator_kws={"num_byzantine": 2}, seed=1,
                    device="cpu", log_path=str(tmp_path / "stream"))
    times = sim.run(model="mlp", streaming=True, fault_model={"dropout_rate": 0.3}, **run)
    assert len(times) == 2
    assert sim.engine.streaming and sim.engine.last_updates is None
    assert (sim.engine.client_chunks, sim.engine.chunk_size) == (2, 4)
    assert int(sim.engine.last_fault_diag["participants"]) <= 7
    dense = Simulator(Synthetic(**kw), attack="signflipping", num_byzantine=2,
                      aggregator="trimmedmean", aggregator_kws={"num_byzantine": 2}, seed=1,
                      device="cpu", log_path=str(tmp_path / "dense"))
    dense.run(model="mlp", fault_model={"dropout_rate": 0.3}, **run)
    ours, theirs = read_stats(str(tmp_path / "stream")), read_stats(str(tmp_path / "dense"))
    assert _stats_shape(ours) == _stats_shape(theirs)
    assert all(np.isfinite(r["Loss"]) for r in ours if r["_meta"]["type"] == "train")


@pytest.mark.parametrize("option", ["retain_updates", "on_round_end"])
def test_streaming_refuses_options_that_read_the_matrix(tmp_path, option):
    sim = Simulator(Synthetic(num_clients=4, train_size=100, cache=False),
                    device="cpu", log_path=str(tmp_path))
    value = True if option == "retain_updates" else (lambda *a: None)
    with pytest.raises(ValueError, match="never materializes"):
        sim.run(model="mlp", streaming=True, **{option: value})


def test_streaming_refuses_parts_without_a_streaming_form(tmp_path):
    ds = Synthetic(num_clients=6, train_size=120, cache=False)
    sim = Simulator(ds, aggregator="dnc", device="cpu", log_path=str(tmp_path))
    with pytest.raises(ValueError, match="does not implement streaming"):
        sim.run(model="mlp", streaming=True, client_chunks=2)
    sim = Simulator(ds, attack="alie", num_byzantine=2, aggregator="median", device="cpu",
                    log_path=str(tmp_path))
    with pytest.raises(ValueError, match="full-population"):
        sim.run(model="mlp", streaming=True, client_chunks=2)
    sim = Simulator(ds, aggregator="median", device="cpu", log_path=str(tmp_path))
    with pytest.raises(ValueError, match="straggler"):
        sim.run(model="mlp", streaming=True, fault_model={"straggler_rate": 0.1})
    # the forensics (slice 10a) follow the JAX package's streaming rules: no
    # diagnostics, an audit fallback only with a streaming form
    with pytest.raises(ValueError, match="cannot collect_diagnostics"):
        sim.run(model="mlp", streaming=True, collect_diagnostics=True)
    with pytest.raises(ValueError, match="audit fallback"):
        sim.run(model="mlp", streaming=True, audit_monitor={"fallback_aggregator": "fltrust"})
    sim.run(model="mlp", streaming=True, audit_monitor={})
    assert "spread_median_lo" in sim.engine.last_audit_diag
    # persistent client state streams (slice 3b); the async buffer does not
    sim.run(model="mlp", streaming=True,
            client_optimizer=ClientOptSpec(name="adam", persist=True))
    count = sim.server.state.client_opt_state[-1][0]
    assert sim.engine.streaming and count.tolist() == [1] * ds.num_clients
    with pytest.raises(ValueError, match="async_config is incompatible"):
        sim.run(model="mlp", streaming=True, async_config={"buffer_m": 2})


def test_unported_choices_raise(tmp_path):
    ds = Synthetic(num_clients=4, train_size=100, cache=False)
    # mesh_shape builds a plan over the run's device (slice 12); a shape
    # whose product is not the device count raises
    sim = Simulator(ds, device="cpu", log_path=str(tmp_path), mesh_shape=(1, 1))
    assert sim.plan is not None and sim.plan.mesh.shape == {"clients": 1, "model": 1}
    with pytest.raises(ValueError, match="!= 1 devices"):
        Simulator(ds, device="cpu", log_path=str(tmp_path), mesh_shape=(2, 1))
    # the async pair and register_attackers are ported (slices 9 and 3b)
    assert repr(Simulator(ds, device="cpu", log_path=str(tmp_path),
                          aggregator="asyncmean").aggregator) == "Asyncmean"
    sim = Simulator(ds, device="cpu", log_path=str(tmp_path), attack="signflipping",
                    num_byzantine=1)
    sim.register_attackers([ByzantineClient(attack=sim.attack) for _ in range(2)])
    assert sim.num_byzantine == 2 and sim.get_clients()[1].is_byzantine()
    # the text models are ported (slice 11b) and take token rows: an image
    # store is refused by name
    with pytest.raises(ValueError, match="sample shape"):
        sim.run(model="text_cct_2")
    with pytest.raises(TypeError, match="unexpected keyword"):
        sim.run(model="mlp", bogus=1)


def _cifar_sim(tmp_path, name):
    ds = Synthetic(num_clients=6, sample_shape=(32, 32, 3), train_size=120, test_size=30,
                   cache=False)
    return Simulator(ds, attack="alie", num_byzantine=2, aggregator="trimmedmean",
                     aggregator_kws={"num_byzantine": 2}, seed=1, device="cpu",
                     log_path=str(tmp_path / name))


def test_cct2_bf16_round_runs(tmp_path):
    sim = _cifar_sim(tmp_path, "bf16")
    times = sim.run(model="cct_2_3x2_32", global_rounds=1, train_batch_size=4,
                    compute_dtype="bfloat16", retain_updates=True)
    assert len(times) == 1
    u = sim.engine.last_updates
    assert u.shape == (6, 283_723) and u.dtype == torch.float32
    assert bool(torch.isfinite(u).all()) and float(u.abs().max()) > 0
    assert all(p.dtype == torch.float32 for p in sim.server.state.params.values())
    recs = read_stats(str(tmp_path / "bf16"))
    assert all(np.isfinite(r["Loss"]) for r in recs if r["_meta"]["type"] in ("train", "test"))


def test_cct2_remat_round_equals_the_round_without(tmp_path):
    """A CCT-2 round with ``remat=True`` runs, its dropout and DropPath masks drawn before
    training, and equals the round without remat within ``rtol=1e-5,
    atol=1e-7`` (bit for bit on the CPU here, which is not required)."""
    ups = {}
    for flag in (True, False):
        sim = _cifar_sim(tmp_path, f"remat{flag}")
        sim.run(model="cct_2_3x2_32", global_rounds=1, train_batch_size=4, remat=flag,
                retain_updates=True)
        assert sim.engine.remat is flag
        ups[flag] = sim.engine.last_updates
    assert ups[True].shape == (6, 283_723) and bool(torch.isfinite(ups[True]).all())
    torch.testing.assert_close(ups[True], ups[False], rtol=1e-5, atol=1e-7)


def test_compute_dtype_rebuilds_stock_specs_only(tmp_path):
    from blades_tpu_torch.models import build_fns, create_model

    sim = _cifar_sim(tmp_path, "spec")
    spec = build_fns(create_model("cct_2_3x2_32"))
    spec.init = lambda g: {"marker": g}
    rebuilt = sim._model_spec(spec, "crossentropy", "bfloat16")
    assert rebuilt is not spec and rebuilt.init is spec.init and rebuilt.rebuild_ok
    assert sim._model_spec(spec, "crossentropy", None) is spec
    spec.rebuild_ok = False
    with pytest.raises(ValueError, match="custom train/eval"):
        sim._model_spec(spec, "crossentropy", "bfloat16")
    with pytest.raises(ValueError, match="not a float dtype"):
        sim._model_spec("cct_2_3x2_32", "crossentropy", "int32")


CATALOG = [("attack", n) for n in ("ipm", "signflipping", "labelflipping", "noise", "minmax",
                                   "minsum")] + [
    ("aggregator", n) for n in ("median", "krum", "multikrum", "geomed", "autogm",
                                "centeredclipping", "clustering", "clippedclustering",
                                "fltrust", "dnc")]


@pytest.mark.parametrize("kind,name", CATALOG, ids=[n for _, n in CATALOG])
def test_catalog_runs_through_simulator(tmp_path, kind, name):
    """Every new attack (with trimmed mean) and aggregator (with ALIE, f=2)
    through ``Simulator(..., device="cpu").run``: two MLP rounds, finite
    stats, the aggregator's state carried from round to round."""
    k, f = 8, 2
    ds = Synthetic(num_clients=k, train_size=160, test_size=40, cache=False)
    agg_kws = {"num_byzantine": f} if name in ("krum", "multikrum", "dnc") else {}
    sim = Simulator(ds, attack=name if kind == "attack" else "alie", num_byzantine=f,
                    aggregator=name if kind == "aggregator" else "trimmedmean",
                    aggregator_kws=agg_kws if kind == "aggregator" else {"num_byzantine": f},
                    seed=2, device="cpu", log_path=str(tmp_path))
    if name == "fltrust":
        sim.set_trusted_clients([sim.get_clients()[-1].id()])
    states = []
    sim.run(model="mlp", global_rounds=2, train_batch_size=4,
            on_round_end=lambda rnd, state, m: states.append(state.agg_state))
    assert sim.engine.device == torch.device("cpu")
    recs = read_stats(str(tmp_path))
    assert [r["Round"] for r in recs if r["_meta"]["type"] == "train"] == [1, 2]
    assert all(np.isfinite(r["Loss"]) for r in recs if r["_meta"]["type"] in ("train", "test"))
    if name == "fltrust":
        assert sim.engine.trusted_mask.tolist() == [False] * (k - 1) + [True]
    if name == "labelflipping":
        assert sim.attack.num_classes == sim._num_classes == 10
    if name == "centeredclipping":
        assert not torch.equal(states[0], states[1])
    if name == "clippedclustering":
        assert [int(s["count"]) for s in states] == [k, 2 * k]


# -- fault models ---------------------------------------------------------------

FAULTS = dict(dropout_rate=0.3, corrupt_clients=(0, 1), corrupt_mode="nan")


@pytest.mark.parametrize("agg_name,agg_kws", [
    ("krum", {"num_byzantine": 2}),
    ("median", {}),
    ("trimmedmean", {"num_byzantine": 2}),
])
def test_simulation_survives_dropout_and_nan_clients(tmp_path, agg_name, agg_kws):
    """The JAX package's acceptance scenario (``tests/test_faults.py``):
    30% dropout and 2 NaN-injecting clients; every round finishes, the
    params and the test loss stay finite, and the NaN clients are excluded
    whenever they participate."""
    from blades_tpu_torch.faults import FaultModel
    from blades_tpu_torch.ops.pytree import ravel

    ds = Synthetic(num_clients=8, train_size=400, test_size=80, noise=0.3, cache=False)
    sim = Simulator(ds, aggregator=agg_name, aggregator_kws=agg_kws, device="cpu",
                    log_path=str(tmp_path))
    diags = []
    times = sim.run("mlp", global_rounds=3, local_steps=1, train_batch_size=8,
                    validate_interval=3, fault_model=FaultModel(**FAULTS),
                    on_round_end=lambda rnd, state, m: diags.append(
                        {n: int(v) for n, v in sim.engine.last_fault_diag.items()}))
    assert len(times) == 3 and len(diags) == 3
    assert np.isfinite(sim.evaluate(3, 64)["Loss"])
    params = ravel(sim.server.state.params, sim.engine.layout)
    assert bool(torch.isfinite(params).all())
    assert all(d["excluded_nonfinite"] == d["corrupted"] <= 2 for d in diags)
    assert any(d["excluded_nonfinite"] > 0 for d in diags)
    assert any(d["dropped"] > 0 for d in diags)
    recs = read_stats(str(tmp_path))
    assert all(np.isfinite(r["Loss"]) for r in recs if r["_meta"]["type"] in ("train", "test"))


def test_fault_run_accepts_kwargs_dict(tmp_path):
    ds = Synthetic(num_clients=6, train_size=120, test_size=30, cache=False)
    sim = Simulator(ds, aggregator="mean", device="cpu", log_path=str(tmp_path))
    sim.run("mlp", global_rounds=2, train_batch_size=4,
            fault_model=dict(dropout_rate=0.5, straggler_rate=0.3))
    fm = sim.engine.fault_model
    assert fm.dropout_rate == 0.5 and fm.has_stragglers
    diag = sim.engine.last_fault_diag
    assert set(diag) == {"participants", "dropped", "stale_replayed", "stragglers_expired",
                         "corrupted", "excluded_nonfinite"}
    assert int(diag["participants"]) + int(diag["dropped"]) <= 6
    state = sim.server.state.fault_state
    assert state["stale"].shape == (6, 59_850) and state["stale"].dtype == torch.float32
    assert state["stale"].device == torch.device("cpu")
