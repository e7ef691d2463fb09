"""Rounds under a fault model of the port against
``blades_tpu.core.RoundEngine``: each registered aggregator runs two K=10
MLP rounds under dropout, stragglers and NaN clients, the second replaying
a straggler; one K=6 CCT-2 round runs under dropout with trimmed mean; and
a NaN round without the non-finite guard. The fault draws are the port's
(``faults.draw_faults`` on the round's ``FAULT`` generator), handed to
``jax.random.bernoulli`` in call order; each round builds a fresh JAX
engine, so its jitted round traces again and takes that round's draws.
Inputs and tolerances as ``tests/test_torch_engine.py`` states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu_torch.aggregators.dnc import draw_subspaces
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.models import build_fns, cct, params_from_jax
from blades_tpu_torch.utils import rng as port_rng

from torch_engine_helpers import (
    CCT_F,
    CCT_K,
    CLIENT_LR,
    FAULTS,
    FAULT_AGGS,
    FAULT_SEED,
    K,
    NO_NOISE,
    SERVER_LR,
    TOL,
    _catalog_id,
    _cct_batches,
    _cct_engine,
    _check_fault_round,
    _check_metrics,
    _engines,
    _flat_params,
    _queue_fault_draws,
    _round,
    jax_params,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("name,kw", FAULT_AGGS,
                         ids=[_catalog_id(("aggregator", c)) for c in FAULT_AGGS])
def test_fault_rounds_per_aggregator_match_jax(jax_params, monkeypatch, name, kw):
    """Two K=10 MLP rounds, ALIE f=4, under dropout 0.3, stragglers 0.2 and
    NaN clients 1 and 2, each aggregator in its masked form: the received
    matrix, the fault counters, the params, the metrics, the straggler
    buffer and the aggregator's state agree with the JAX engine."""
    trusted = (np.arange(K) == K - 1) if name == "fltrust" else None
    fm = FaultModel(**FAULTS)
    j, t = _engines(jax_params, 1, aggregator=(name, kw), trusted=trusted, faults=FAULTS)
    jstate = j[1]
    replayed = []
    for rnd in range(2):
        # a fresh JAX engine: its round traces again and takes this round's draws
        (jeng, _), _ = _engines(jax_params, 1, aggregator=(name, kw), trusted=trusted,
                                faults=FAULTS)
        queue = _queue_fault_draws(monkeypatch, fm, 59_850, FAULT_SEED, rnd)
        agg_queue = []
        if name == "dnc":
            agg_queue = [a.numpy() for pair in draw_subspaces(
                port_rng.generator(FAULT_SEED, rnd, port_rng.AGG), t[0].aggregator.num_iters,
                59_850, t[0].aggregator.sub_dim, "cpu") for a in pair]
            take = lambda *args, **kwargs: jnp.asarray(agg_queue.pop(0))  # noqa: E731
            monkeypatch.setattr(jax.random, "normal", take)
            monkeypatch.setattr(jax.random, "choice", take)
            with jax.disable_jit():
                (jeng, jstate), t, jm, tm = _round((jeng, jstate), t, rnd, seed=FAULT_SEED)
        else:
            (jeng, jstate), t, jm, tm = _round((jeng, jstate), t, rnd, seed=FAULT_SEED)
        assert queue == [] and agg_queue == []
        teng, tstate, layout = t
        _check_fault_round(jeng, jstate, teng, tstate, layout, jm, tm)
        replayed.append(int(teng.last_fault_diag["stale_replayed"]))
        if teng.aggregator.stateful:
            jst = jax.tree_util.tree_leaves(jstate.agg_state)
            tst = jax.tree_util.tree_leaves(tstate.agg_state)
            assert len(jst) == len(tst)
            for a, b in zip(tst, jst):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert replayed == [0, 1]
    assert int(teng.last_fault_diag["participants"]) < K


def test_cct2_fault_round_matches_jax(monkeypatch):
    """One K=6 CCT-2 round (D = 283,723) under dropout 0.3 with trimmed mean
    b=2: the masked trimmed mean against the JAX engine's."""
    faults = dict(dropout_rate=0.3)
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), (32, 32, 3))
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tspec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams,
        num_clients=CCT_K, num_byzantine=CCT_F,
        attack=JaxAlie(num_clients=CCT_K, num_byzantine=CCT_F),
        aggregator=JaxTrimmedmean(num_byzantine=2), plan=None, keep_updates=True,
        fault_model=JaxFaultModel(**faults),
    )
    tparams = params_from_jax(jparams, tspec.layout)
    teng = _cct_engine(tspec, tparams)
    teng.fault_model = FaultModel(**faults)
    queue = _queue_fault_draws(monkeypatch, teng.fault_model, 283_723, 0, 0)
    cx, cy = _cct_batches(202)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx),
                                torch.from_numpy(cy), CLIENT_LR, SERVER_LR)
    assert queue == []
    diag = {n: int(v) for n, v in teng.last_fault_diag.items()}
    assert diag == {n: int(v) for n, v in jeng.last_fault_diag.items()}
    assert 0 < diag["dropped"] < CCT_K
    np.testing.assert_allclose(teng.last_updates.numpy(), np.asarray(jeng.last_updates), **TOL)
    np.testing.assert_allclose(*_flat_params(jstate, tstate, tspec.layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])


def test_unguarded_nan_fault_round_with_trimmed_mean_matches_jax(jax_params):
    """One K=10 MLP round with the non-finite guard off, client 6 scheduled
    out and clients 5, 7 and 8 delivering NaN rows, under trimmed mean b=2:
    more NaN participants than b, so a kept slot of the masked trim holds
    the masked-out row (sanitized to 0). The port's round equals the JAX
    engine's, and its params stay finite."""
    sched = np.ones((1, K), bool)
    sched[0, 6] = False
    faults = dict(participation_schedule=sched, corrupt_clients=(5, 7, 8),
                  guard_nonfinite=False)
    j, t = _engines(jax_params, 1, aggregator=("trimmedmean", {"num_byzantine": 2}),
                    faults=faults)
    (jeng, jstate), (teng, tstate, layout), jm, tm = _round(j, t, 0)
    diag = {n: int(v) for n, v in teng.last_fault_diag.items()}
    assert diag == {n: int(v) for n, v in jeng.last_fault_diag.items()}
    assert diag["participants"] == K - 1 and diag["excluded_nonfinite"] == 0
    assert diag["corrupted"] == 3
    np.testing.assert_allclose(teng.last_updates.numpy(), np.asarray(jeng.last_updates), **TOL)
    tp, jp = _flat_params(jstate, tstate, layout)
    assert np.isfinite(tp).all()
    np.testing.assert_allclose(tp, jp, **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])
