"""The port's streaming round against the JAX package's streaming round:
the engine's build-time validation and ``peak_update_bytes``; K=7 MLP
streaming rounds (2 chunks, pad 1) under sign flipping, label flipping and
noise, with and without a fault model; a round with no participant; the
exact forms' streaming rounds (mean, centered clipping with ``n_iter=1``)
against the port's dense rounds at f32 ``rtol=1e-5, atol=1e-6``; the
streaming fault counters against the dense round's.

The JAX streaming round draws per chunk (the noise attack's normals and the
bit-flip pattern, from ``fold_in(key, chunk)``). The port draws them from
its per-chunk generators (``utils/rng.py``, ``chunk=``), and the tests hand
those draws to ``jax.random.normal`` / ``jax.random.bernoulli`` in call
order, with the JAX round run eagerly (``jax.disable_jit``) so that its
chunk scan calls them once a chunk. Rounds are held at ``rtol=1e-4,
atol=1e-5`` (the variance metrics ``atol=1e-12``), as in
``tests/test_torch_engine.py``.
"""

import numpy as np
import pytest
import torch

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu_torch.core import ClientOptSpec
from blades_tpu_torch.ops.pytree import ravel

from torch_streaming_helpers import (
    ATTACKS,
    CLIENT_LR,
    EXACT_TOL,
    F,
    FAULT_CASES,
    K,
    OPTOUTS,
    SERVER_LR,
    _batches,
    _check_round,
    _port_engine,
    _run_both,
    _stream_engines,
    jax_params,
)


def test_build_time_validation():
    for name in OPTOUTS:
        reason = jax_get_aggregator(name).streaming_optouts["streaming"]
        with pytest.raises(ValueError) as err:
            _port_engine(aggregator=(name, {}))
        assert reason in str(err.value)
    for name, kw in (("alie", {"num_clients": K, "num_byzantine": F}), ("ipm", {}),
                     ("minmax", {}), ("minsum", {})):
        with pytest.raises(ValueError, match="full-population"):
            _port_engine(attack=(name, kw))
    with pytest.raises(ValueError, match="straggler"):
        _port_engine(faults=dict(straggler_rate=0.2))
    # persistent client state streams (slice 3b); async does not
    persisted, _ = _port_engine(client_opt=ClientOptSpec(persist=True))
    assert persisted.streaming and persisted.client_opt.persist
    from blades_tpu_torch.asyncfl import AsyncConfig

    with pytest.raises(ValueError, match="async_config is incompatible"):
        _port_engine(async_config=AsyncConfig())
    # the dense round takes all of these but the population attacks' absence
    dense, _ = _port_engine(aggregator=("fltrust", {}), attack=("alie", {
        "num_clients": K, "num_byzantine": F}), streaming_on=False)
    assert not dense.streaming and dense.keep_updates


def test_peak_update_bytes_and_keep_updates():
    eng, _ = _port_engine(chunks=2)
    assert (eng.client_chunks, eng.chunk_size, eng._pad) == (2, 4, 1)
    assert eng.peak_update_bytes == 4 * 59_850 * 4 and not eng.keep_updates
    dense, _ = _port_engine(chunks=2, streaming_on=False)
    assert dense.peak_update_bytes == K * 59_850 * 4


@pytest.mark.parametrize("faults", sorted(FAULT_CASES))
@pytest.mark.parametrize("attack", ATTACKS, ids=[a for a, _ in ATTACKS])
def test_mlp_streaming_round_matches_jax(jax_params, monkeypatch, attack, faults):
    """Two K=7 MLP streaming rounds of 2 chunks (4 + 3, pad 1), f=2, trimmed
    mean b=2, against the JAX streaming engine."""
    fm = FAULT_CASES[faults]
    j, t = _stream_engines(jax_params, ("trimmedmean", {"num_byzantine": 2}), attack, fm)
    for rnd in range(2):
        if fm is not None:  # a fresh JAX engine traces again and takes this round's draws
            j = (_stream_engines(jax_params, ("trimmedmean", {"num_byzantine": 2}), attack,
                                 fm)[0][0], j[1])
        j, t, jm, tm = _run_both(monkeypatch, j, t, rnd, seed=2)
        _check_round(j, t, jm, tm)
    if fm is not None:
        assert int(t[0].last_fault_diag["participants"]) < K


def test_mlp_streaming_round_with_no_participant_applies_zero():
    sched = np.zeros((1, K), bool)
    eng, params = _port_engine(faults=dict(participation_schedule=sched), chunks=3)
    state = eng.init(params)
    cx, cy = (torch.from_numpy(a) for a in _batches(0))
    new, m = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR)
    assert float(m.agg_norm) == 0.0 and int(eng.last_fault_diag["participants"]) == 0
    for n in params:
        torch.testing.assert_close(new.params[n], state.params[n], rtol=0, atol=0)


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("aggregator", [("mean", {}), ("centeredclipping", {"n_iter": 1})],
                         ids=["mean", "centeredclipping-n1"])
def test_exact_streaming_round_equals_dense_round(aggregator, chunks):
    """Three MLP rounds under sign flipping: the streaming round of an exact
    form equals the
    port's dense round (f32 ``rtol=1e-5, atol=1e-6``), and so do the losses;
    the one-pass variance within ``rtol=1e-4``."""
    out = {}
    for on in (True, False):
        eng, params = _port_engine(aggregator=aggregator, chunks=chunks, streaming_on=on)
        state = eng.init(params)
        ms = []
        for rnd in range(3):
            cx, cy = (torch.from_numpy(a) for a in _batches(rnd))
            state, m = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR, seed=9)
            ms.append(m)
        out[on] = (ravel(state.params, eng.layout), ms, state.agg_state)
    torch.testing.assert_close(out[True][0], out[False][0], **EXACT_TOL)
    for ms, md in zip(out[True][1], out[False][1]):
        assert float(ms.train_loss) == pytest.approx(float(md.train_loss), rel=1e-6)
        assert float(ms.update_variance) == pytest.approx(float(md.update_variance), rel=1e-4)
        assert float(ms.agg_norm) == pytest.approx(float(md.agg_norm), rel=1e-5)
    if aggregator[0] == "centeredclipping":
        torch.testing.assert_close(out[True][2], out[False][2], **EXACT_TOL)


def test_streaming_fault_counters_equal_dense_counters():
    """Dropout and NaN corruption: the streaming round's fault counters
    equal the port's dense round's on the same seed, every round."""
    faults = dict(dropout_rate=0.3, corrupt_rate=0.3)
    counters = {}
    for on in (True, False):
        eng, params = _port_engine(faults=faults, chunks=3, streaming_on=on)
        state, seen = eng.init(params), []
        for rnd in range(3):
            cx, cy = (torch.from_numpy(a) for a in _batches(rnd))
            state, _ = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR, seed=11)
            seen.append({n: int(v) for n, v in eng.last_fault_diag.items()})
        counters[on] = seen
    assert counters[True] == counters[False]
    assert sum(c["excluded_nonfinite"] for c in counters[True]) > 0
