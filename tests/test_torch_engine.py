"""One MLP round of the port against ``blades_tpu.core.RoundEngine`` (the
CCT-2 rounds are in ``tests/test_torch_engine_cct.py``, the fault rounds in
``tests/test_torch_engine_faults.py``, the optimizers in
``tests/test_torch_engine_optim.py``, the shared helpers in
``tests/torch_engine_helpers.py``).

Every attack and dense aggregator of the catalog runs one K=10 MLP round
against the JAX engine: each new attack with trimmed mean, each new
aggregator with ALIE (f=4). The noise attack's normals and DnC's draws are
the port's, handed to the JAX package by patching ``jax.random.normal`` and
``jax.random.choice``; for DnC the JAX round then runs eagerly
(``jax.disable_jit``) so that each DnC iteration takes its own draw.

BASELINE config 1's shape: K=10 clients, f=4 byzantine, ALIE + trimmed mean
(b=5 shrunk to 4), plain SGD. The initial params (the JAX package's init,
carried over) and every round's ``[K, S, B, ...]`` batches are drawn once
and handed to both engines. The JAX engine runs with ``plan=None``, as its
own tests run it: the conftest's virtual 8-device mesh would make its
Simulator shard.

Tolerances, f32: one round ``rtol=1e-4, atol=1e-5`` on the ``[K, D]``
matrix, the aggregate and the new params; the scalar metrics ``rtol=1e-4``
and, for the variance metrics (about 1e-7 in size), ``atol=1e-12``. The two
frameworks' CPU matmuls and reductions sum in different orders, and local
training compounds that over the local steps. Three rounds: ``rtol=1e-3,
atol=1e-5``, since each round's small differences feed the next.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu_torch.aggregators.dnc import draw_subspaces
from blades_tpu_torch.attackers.noise import draw_normals
from blades_tpu_torch.utils import rng as port_rng

from torch_engine_helpers import (
    AGG_CASES,
    ATTACK_CASES,
    CLIENT_LR,
    F,
    K,
    SERVER_LR,
    TOL,
    TOL_3,
    _batches,
    _catalog_id,
    _check_metrics,
    _engines,
    _flat_params,
    _round,
    jax_params,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("client_chunks", [1, 3])
def test_one_round_matches_jax(jax_params, client_chunks):
    j, t = _engines(jax_params, client_chunks)
    j, t, jm, tm = _round(j, t, 0)
    (jeng, jstate), (teng, tstate, layout) = j, t
    assert teng.chunk_size == jeng.chunk_size
    assert teng.client_chunks == jeng.client_chunks

    ju, tu = np.asarray(jeng.last_updates), teng.last_updates
    assert tu.shape == (K, 59_850)
    np.testing.assert_allclose(tu.numpy(), ju, **TOL)
    # ALIE wrote one vector into every byzantine row, in both engines
    np.testing.assert_array_equal(tu[:F].numpy(), np.repeat(tu[:1].numpy(), F, 0))

    jagg, _ = jeng.aggregator.aggregate(jnp.asarray(ju))
    tagg, _ = teng.aggregator.aggregate(tu)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), **TOL)
    np.testing.assert_allclose(*_flat_params(jstate, tstate, layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])
    assert tstate.round_idx == int(jstate.round_idx) == 1
    # without a fault model the round is the dense one
    assert teng.last_fault_diag is None and tstate.fault_state == ()


def test_three_round_trajectory_matches_jax(jax_params):
    j, t = _engines(jax_params, 1)
    for rnd in range(3):
        j, t, jm, tm = _round(j, t, rnd)
        _check_metrics(jm, tm, rtol=TOL_3["rtol"])
    np.testing.assert_allclose(*_flat_params(j[1], t[1], t[2]), **TOL_3)
    assert np.isfinite(float(tm.train_loss))


@pytest.mark.parametrize("case", [("attack", c) for c in ATTACK_CASES]
                         + [("aggregator", c) for c in AGG_CASES], ids=_catalog_id)
def test_one_round_per_attack_and_aggregator_matches_jax(jax_params, monkeypatch, case):
    kind, (name, kw) = case
    trusted = (np.arange(K) == K - 1) if name == "fltrust" else None
    j, t = _engines(jax_params, 1, attack=(name, kw) if kind == "attack" else None,
                    aggregator=(name, kw) if kind == "aggregator" else None, trusted=trusted)
    (jeng, jstate), (teng, tstate, layout) = j, t
    # the port's draws (root seed 0, round 0), handed to the JAX package
    draws = []
    if name == "noise":
        draws = [draw_normals((K, 59_850), port_rng.generator(0, 0, port_rng.ATTACK), "cpu")]
    if name == "dnc":
        draws = [a for pair in draw_subspaces(port_rng.generator(0, 0, port_rng.AGG),
                                              teng.aggregator.num_iters, 59_850,
                                              teng.aggregator.sub_dim, "cpu") for a in pair]
    queue = [d.numpy() for d in draws]

    def take(*args, **kwargs):
        return jnp.asarray(queue.pop(0))

    if draws:
        monkeypatch.setattr(jax.random, "normal", take)
        monkeypatch.setattr(jax.random, "choice", take)
    if name == "dnc":
        with jax.disable_jit():
            j, t, jm, tm = _round(j, t, 0)
    else:
        j, t, jm, tm = _round(j, t, 0)
    assert queue == []  # the JAX side took every draw
    (jeng, jstate), (teng, tstate, layout) = j, t
    ju, tu = np.asarray(jeng.last_updates), teng.last_updates
    np.testing.assert_allclose(tu.numpy(), ju, **TOL)
    if name in ("ipm", "minmax", "minsum"):
        # one malicious vector in every byzantine row
        np.testing.assert_array_equal(tu[:F].numpy(), np.repeat(tu[:1].numpy(), F, 0))
    np.testing.assert_allclose(*_flat_params(jstate, tstate, layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])
    if kind == "aggregator" and name in ("centeredclipping", "clippedclustering"):
        jst, tst = jstate.agg_state, tstate.agg_state
        if name == "centeredclipping":
            np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
        else:
            np.testing.assert_allclose(tst["norms"].numpy(), np.asarray(jst["norms"]), **TOL)
            assert int(tst["count"]) == int(jst["count"]) == K


def test_dishonest_training_attacks_change_only_byzantine_rows(jax_params):
    """Sign and label flipping act inside local training, on the byzantine
    clients' rows alone: against the same round without an attack, the
    honest rows are unchanged and the byzantine rows moved."""
    _, (plain, pstate, _) = _engines(jax_params, 1, attack=(None, {}))
    cx, cy = (torch.from_numpy(a) for a in _batches(0))
    plain.run_round(pstate, cx, cy, CLIENT_LR, SERVER_LR)
    for name in ("signflipping", "labelflipping"):
        _, (eng, state, _) = _engines(jax_params, 2, attack=(name, {}))
        eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR)
        honest = ~eng.byz_mask
        torch.testing.assert_close(eng.last_updates[honest], plain.last_updates[honest],
                                   rtol=1e-6, atol=1e-7)
        assert not torch.allclose(eng.last_updates[:F], plain.last_updates[:F])
