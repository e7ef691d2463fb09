"""The port's multi-process runtime (``blades_tpu_torch/parallel/distributed.py``
and ``_dist_worker.py``) against the JAX package's.

A job here is CPU processes on localhost joined into one gloo group, the
counterpart of the JAX package's processes of virtual CPU devices
(``tests/test_distributed.py:115``). The 2-rank round takes the JAX
package's MLP init (its flat vector in an ``.npz``, read through the port's
weight map), so its ``train_loss`` and ``agg_norm`` are held to JAX's
2-process cluster at ``rtol=1e-4``; the ranks agree with each other, and
with the same round run in this process on an 8-entry virtual mesh, at
``rtol=1e-5``; the 2-rank round on a placed store (``--placed``) is held
to the same store's round sampled unplaced in this process at that bar.
NCCL's form needs the card (``chip_smoke.py``,
``parallel_dist_nccl``; NCCL refuses two ranks on one device).
"""

import time
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.models.common import build_fns as jax_build_fns
from blades_tpu.models.mlp import MLP as JaxMLP
from blades_tpu.parallel._dist_worker import run_local_cluster as jax_run_local_cluster
from blades_tpu_torch.parallel import distributed as dist
from blades_tpu_torch.parallel import make_plan
from blades_tpu_torch.parallel._dist_worker import (
    make_data,
    make_store,
    round_summary,
    run_local_cluster,
    run_round,
    sample_store,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


def test_initialize_single_process_noop(monkeypatch):
    for v in dist._CLUSTER_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    dist.initialize()  # no job in the environment: must not contact anything
    dist.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert dist.is_coordinator() and dist.world_size() == 1
    assert dist.backend_for("cpu") == "gloo" and dist.backend_for("cuda:0") == "nccl"


def test_initialize_explicit_failure_raises():
    with pytest.raises(ValueError, match="together"):
        dist.initialize(coordinator_address="127.0.0.1:1", num_processes=2)
    # a coordinator address the group cannot use: init_process_group's own
    # error, not a warning and not a quiet single-process run
    with pytest.raises(ValueError, match="Port"):
        dist.initialize("127.0.0.1:notaport", 2, 1, device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_autodetect_warns(monkeypatch):
    """A job the environment names that fails to join warns (it would run
    unsharded); no job stays quiet; explicit arguments re-raise."""
    def boom(*a, **kw):
        raise RuntimeError("connection to coordinator 10.0.0.1:1234 timed out")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    for v in dist._CLUSTER_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dist.initialize()  # no job: quiet, and init_process_group never called
    for v, val in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                   ("WORLD_SIZE", "2"), ("RANK", "1")):
        monkeypatch.setenv(v, val)
    with pytest.warns(RuntimeWarning, match="coordinator"):
        dist.initialize(device="cpu")
    with pytest.raises(RuntimeError, match="timed out"):
        dist.initialize("10.0.0.1:1234", 2, 0, device="cpu")
    # a partial environment (no RANK) names no job: quiet
    monkeypatch.delenv("RANK")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dist.initialize(device="cpu")


@pytest.fixture(scope="module")
def jax_flat(tmp_path_factory):
    """The JAX worker's init (``blades_tpu/parallel/_dist_worker.py:47-48``)
    as a flat vector in an ``.npz``."""
    spec = jax_build_fns(JaxMLP(num_classes=10), sample_shape=(28, 28, 1))
    flat = np.asarray(ravel_pytree(spec.init(jax.random.PRNGKey(0)))[0])
    path = tmp_path_factory.mktemp("dist") / "init.npz"
    np.savez(path, flat=flat)
    return flat, path


def test_two_rank_gloo_cluster_matches_jax(jax_flat):
    flat, path = jax_flat
    results = run_local_cluster(2, 4, timeout=300, params_path=path)
    assert set(results) == {0, 1}
    for pid, r in results.items():
        assert r["num_processes"] == 2 and r["backend"] == "gloo"
        assert r["local_devices"] == 4 and r["global_devices"] == 8
        assert r["is_coordinator"] == (pid == 0)
        # each process held only its own contiguous client block
        assert r["client_slice"] == [pid * 8, (pid + 1) * 8]
        for key in ("train_loss", "agg_norm", "params_sum", "params_norm"):
            assert r[key] == pytest.approx(results[0][key], rel=1e-5), key
    # the same workload in this process, on an 8-entry virtual mesh
    cx, cy = make_data(16, 2, 4)
    mesh = dist.make_global_mesh(local_devices=[torch.device("cpu")] * 8)
    local = round_summary(*run_round(make_plan(mesh), 16, torch.from_numpy(cx),
                                     torch.from_numpy(cy), 4, flat))
    for key, value in local.items():
        assert results[0][key] == pytest.approx(value, rel=1e-5), key
    # and JAX's 2-process cluster of 4 virtual devices each
    ref = jax_run_local_cluster(2, 4, timeout=500)
    for key in ("train_loss", "agg_norm"):
        assert results[0][key] == pytest.approx(ref[0][key], rel=1e-4), key


def test_two_rank_gloo_cluster_samples_a_placed_store(jax_flat):
    """The workers build their round's batches from a client store placed
    on the job mesh (``--placed``): each rank keeps only its K/2 store rows
    (one piece of 2 clients per clients-axis row of its 4), samples them
    from the shared generator, and the round equals the same store's round
    sampled unplaced in this process on an 8-entry virtual mesh."""
    flat, path = jax_flat
    results = run_local_cluster(2, 4, timeout=300, params_path=path, placed=True)
    assert set(results) == {0, 1}
    for pid, r in results.items():
        assert r["placed"] and r["store_rows"] == [pid * 8, (pid + 1) * 8]
        assert r["store_pieces"] == [2, 2, 2, 2] and r["batch_rows"] == r["store_rows"]
        for key in ("train_loss", "agg_norm", "params_sum", "params_norm"):
            assert r[key] == pytest.approx(results[0][key], rel=1e-5), key
    fl = make_store(16)
    cx, cy = sample_store(fl, 2, 4)
    assert isinstance(cx, torch.Tensor) and cx.shape == (16, 2, 4, 28, 28, 1)
    mesh = dist.make_global_mesh(local_devices=[torch.device("cpu")] * 8)
    local = round_summary(*run_round(make_plan(mesh), 16, cx, cy, 4, flat))
    for key, value in local.items():
        assert results[0][key] == pytest.approx(value, rel=1e-5), key


def test_worker_failure_fails_fast_and_reaps():
    """Kill one rank mid-flight: the harness reports it promptly (its peer
    waits at the group's rendezvous or a collective) and reaps the other."""
    spawned = []

    def injector(procs):
        spawned.extend(procs)
        time.sleep(2)
        procs[1].kill()

    t0 = time.time()
    with pytest.raises(RuntimeError, match=r"worker 1 failed \(rc=-9\)"):
        run_local_cluster(2, 4, timeout=300, _fault_injector=injector)
    assert time.time() - t0 < 60
    assert len(spawned) == 2
    assert all(p.poll() is not None for p in spawned), "unreaped workers"
