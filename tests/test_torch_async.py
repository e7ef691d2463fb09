"""The port's buffered-asynchronous round (``blades_tpu_torch/asyncfl``)
against the JAX package's (``blades_tpu/asyncfl``).

Covered: ``ArrivalProcess`` and ``AsyncConfig`` (every validation case,
``history_len``, ``repr``, the geometric draw's transform on the same
uniforms, the draws' ranges), ``staleness_mask_weights`` in its three
modes, the async aggregators' ``aggregate`` with and without ``present``;
the degenerate contract (``buffer_m=K``, zero delays, constant weighting:
bit-identical to the port's own sync round for every registered
aggregator over 3 rounds, and within tolerance of the JAX package's);
fixed, uniform and geometric delays over 4 ticks against the JAX async
engine (the params, every field of ``async_state``, the 10 counters); a
tick that does not fire; the cutoff; version-lagged training; dropout
faults; persistent Adam state; the engine's build checks and
``Simulator.run(async_config=...)``.

The arrival draws and the fault draws are the port's, handed to the JAX
package: its ``async_config.arrivals.draw`` is replaced on the instance,
and ``jax.random.bernoulli`` is patched in call order, with a fresh JAX
engine each tick (its round is jitted, so the draws become constants of
the trace) and the state carried across, as PR 5's fault tests do.

Tolerances, f32: ``rtol=1e-5`` (``1e-6`` where the weights are compared);
rounds ``rtol=1e-4, atol=1e-5`` for one tick, ``rtol=1e-3, atol=1e-5``
over several, as in ``tests/test_torch_engine.py``; integer state and
counts exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.asyncfl import ArrivalProcess as JaxArrivalProcess
from blades_tpu.asyncfl import AsyncConfig as JaxAsyncConfig
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.core import ClientOptSpec as JaxClientOptSpec
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu_torch import Simulator
from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator
from blades_tpu_torch.asyncfl import ArrivalProcess, AsyncConfig, geometric_delays
from blades_tpu_torch.asyncfl.arrivals import U_MIN
from blades_tpu_torch.attackers import Alie
from blades_tpu_torch.core import ClientOptSpec, RoundEngine, RoundMetrics, ServerOptSpec
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.models import create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.utils import rng as port_rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

K, F, S, B, D = 10, 4, 1, 8, 59_850
CLIENT_LR, SERVER_LR = 0.1, 1.0
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_N = dict(rtol=1e-3, atol=1e-5)
DIAG = ("arrivals", "deposited", "buffer_count", "fired", "aggregated", "fires_total",
        "mean_staleness", "max_staleness", "stale_excluded", "weight_min")


# -- ArrivalProcess and AsyncConfig -----------------------------------------------------

BAD_ARRIVALS = [dict(kind="bogus"), dict(max_delay=-1), dict(kind="fixed"),
                dict(kind="fixed", delays=(0, -1)),
                dict(kind="uniform", min_delay=3, max_delay=2),
                dict(kind="uniform", min_delay=-1, max_delay=2)]
GOOD_ARRIVALS = [dict(), dict(kind="zero", max_delay=4), dict(kind="fixed", delays=(0, 3, 1)),
                 dict(kind="fixed", delays=(0, 1), max_delay=5),
                 dict(kind="uniform", min_delay=1, max_delay=3),
                 dict(kind="geometric", mean_delay=1.5, max_delay=4)]
BAD_CONFIGS = [dict(staleness="bogus"), dict(buffer_m=0), dict(staleness="cutoff"),
               dict(staleness="cutoff", cutoff=-1), dict(arrivals=dict(kind="bogus"))]
GOOD_CONFIGS = [dict(), dict(buffer_m=3, staleness="polynomial", alpha=0.7),
                dict(staleness="cutoff", cutoff=0),
                dict(buffer_m=2, arrivals=dict(kind="uniform", max_delay=2))]


def _raised(cls, kw):
    try:
        cls(**kw)
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", BAD_ARRIVALS + BAD_CONFIGS, ids=str)
def test_validation_raises_as_jax(kw):
    ours = ArrivalProcess if kw in BAD_ARRIVALS else AsyncConfig
    ref = JaxArrivalProcess if kw in BAD_ARRIVALS else JaxAsyncConfig
    got = _raised(ours, kw)
    assert got is not None and got == _raised(ref, kw)


@pytest.mark.parametrize("kw", GOOD_ARRIVALS, ids=str)
def test_arrival_process_matches_jax(kw):
    ours, ref = ArrivalProcess(**kw), JaxArrivalProcess(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.history_len == ref.history_len == ours.max_delay + 1
    assert repr(ours) == repr(ref)


@pytest.mark.parametrize("kw", GOOD_CONFIGS, ids=str)
def test_async_config_and_init_state_match_jax(kw):
    ours, ref = AsyncConfig(**kw), JaxAsyncConfig(**kw)
    assert repr(ours) == repr(ref)
    assert isinstance(ours.arrivals, ArrivalProcess)
    assert ours.weights_are_identity == ref.weights_are_identity
    tstate, jstate = ours.init_state(5, 7), ref.init_state(5, 7)
    assert set(tstate) == set(jstate)
    for n, j in jstate.items():
        assert tstate[n].shape == j.shape and not tstate[n].any()
        assert str(tstate[n].dtype).split(".")[-1] == str(j.dtype)


def test_geometric_transform_matches_jax_on_the_same_uniforms():
    """``floor(log(u) / log1p(-p))`` clipped to ``[0, max_delay]``, float32
    in both packages, on the same 100,000 seeded uniforms on ``[1e-7, 1)``
    (their ends included) for three means."""
    u = np.random.RandomState(0).uniform(U_MIN, 1.0, 100_000).astype(np.float32)
    u[:2] = (U_MIN, np.nextafter(np.float32(1), np.float32(0)))
    for mean, cap in ((0.5, 3), (1.0, 3), (4.0, 20)):
        got = geometric_delays(torch.from_numpy(u), mean, cap)
        p = 1.0 / (1.0 + mean)
        ref = jnp.clip(jnp.floor(jnp.log(jnp.asarray(u)) / jnp.log1p(-p)).astype(jnp.int32), 0,
                       cap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got.min() == 0 and got.max() == cap


def _arrival_draws(proc, seed, rnd, k):
    """``proc``'s delays of tick ``rnd`` from the round's ARRIVAL generator,
    as the engine draws them."""
    return proc.draw(k, port_rng.generator(seed, rnd, port_rng.ARRIVAL))


def test_draws_are_seeded_and_in_range():
    for kw, lo, hi in ((dict(kind="uniform", min_delay=1, max_delay=3), 1, 3),
                       (dict(kind="geometric", mean_delay=1.0, max_delay=3), 0, 3)):
        proc = ArrivalProcess(**kw)
        a, b = _arrival_draws(proc, 4, 2, 1000), _arrival_draws(proc, 4, 2, 1000)
        assert torch.equal(a, b) and a.dtype == torch.int32 and a.shape == (1000,)
        assert int(a.min()) == lo and int(a.max()) == hi
        assert not torch.equal(a, _arrival_draws(proc, 4, 3, 1000))
    fixed = ArrivalProcess(kind="fixed", delays=(2, 0, 1))
    assert fixed.draw(3, None).tolist() == [2, 0, 1]
    with pytest.raises(ValueError, match="num_clients"):
        fixed.draw(4, None)
    assert not ArrivalProcess().draw(3, None).any()


@pytest.mark.parametrize("mode", ["constant", "polynomial", "cutoff"])
def test_staleness_mask_weights_match_jax(mode):
    """Seeded staleness and occupancy, every mode: the mask exactly, the
    weights exactly (constant, cutoff) or within ``rtol=1e-6``
    (polynomial), normalised to mean 1 over the mask."""
    kw = dict(staleness=mode, alpha=0.7, cutoff=2 if mode == "cutoff" else None)
    ours, ref = AsyncConfig(**kw), JaxAsyncConfig(**kw)
    rng = np.random.RandomState(11)
    for trial in range(20):
        tau = rng.randint(-1, 6, 40).astype(np.int32)
        mask = rng.rand(40) < (0.0 if trial == 0 else 0.6)
        tm, tw = ours.staleness_mask_weights(torch.from_numpy(tau), torch.from_numpy(mask))
        jm, jw = ref.staleness_mask_weights(jnp.asarray(tau), jnp.asarray(mask))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert tw.dtype == torch.float32
        if mode == "polynomial":
            np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
            if mask.any():
                assert float(tw[tm].mean()) == pytest.approx(1.0, rel=1e-6)
                assert float(tw[tm].min()) < 1.0 < float(tw[tm].max())
        else:
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert (tw[~tm] == 1.0).all()


# -- the async aggregators -------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [("asyncmean", {}), ("asynccenteredclipping", {}),
                                     ("asynccenteredclipping", {"tau": 0.05, "n_iter": 3})])
def test_async_aggregators_match_jax(name, kw):
    """``aggregate`` without ``present`` and with it, three rounds of
    state; with ``present`` the 1/K damping: absent rows add 0 but count."""
    ours, ref = get_aggregator(name, **kw), jax_get_aggregator(name, **kw)
    rng = np.random.RandomState(12)
    tstate, jstate = ours.init_state(8, 33), ref.init_state(8, 33)
    for rnd in range(3):
        u = (rng.randn(8, 33) * 0.1).astype(np.float32)
        present = None if rnd == 0 else rng.rand(8) < 0.6
        tkw = {} if present is None else {"present": torch.from_numpy(present)}
        jkw = {} if present is None else {"present": jnp.asarray(present)}
        got, tstate = ours.aggregate(torch.from_numpy(u), tstate, **tkw)
        expect, jstate = ref.aggregate(jnp.asarray(u), jstate, **jkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)
        if name == "asyncmean" and present is not None:
            np.testing.assert_allclose(got.numpy(), u[present].sum(0) / 8, rtol=1e-6)
    if ours.stateful:
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), rtol=1e-5, atol=1e-6)


# -- rounds ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _batches(rnd, k=K):
    rng = np.random.RandomState(700 + rnd)
    cx = rng.randn(k, S, B, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (k, S, B)).astype(np.int32)
    return cx, cy


def _agg_kw(name):
    return {"num_byzantine": 2} if name in ("trimmedmean", "krum", "multikrum", "dnc") else {}


def _port(params, spec, aggregator="trimmedmean", async_config=None, k=K, f=F, **kw):
    return RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout, num_clients=k,
        num_byzantine=f, attack=Alie(num_clients=k, num_byzantine=f),
        aggregator=get_aggregator(aggregator, **_agg_kw(aggregator)), device="cpu",
        async_config=async_config, keep_updates=True, **kw)


def _jax(jax_params, aggregator, cfg_kw, faults=None, client_opt=None, chunks=1):
    jspec = jax_mlp()
    return JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jax_params, num_clients=K, num_byzantine=F,
        attack=JaxAlie(num_clients=K, num_byzantine=F),
        aggregator=jax_get_aggregator(aggregator, **_agg_kw(aggregator)), plan=None,
        async_config=None if cfg_kw is None else JaxAsyncConfig(**cfg_kw),
        keep_updates=True, client_chunks=chunks,
        fault_model=None if faults is None else JaxFaultModel(**faults),
        client_opt=JaxClientOptSpec(**(client_opt or {})))


def _check_tick(jeng, jstate, teng, tstate, jm, tm, tol):
    np.testing.assert_allclose(ravel(tstate.params, teng.layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **tol)
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else tol["atol"]
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=tol["rtol"], atol=atol, err_msg=name)
    ta, ja = tstate.async_state, jstate.async_state
    assert set(ta) == set(ja)
    for n, j in ja.items():
        if np.asarray(j).dtype.kind == "f":
            np.testing.assert_allclose(ta[n].numpy(), np.asarray(j), **tol, err_msg=n)
        else:
            np.testing.assert_array_equal(ta[n].numpy(), np.asarray(j), err_msg=n)
    td, jd = teng.last_async_diag, jeng.last_async_diag
    assert set(td) == set(jd) == set(DIAG)
    for n in DIAG:
        if n in ("mean_staleness", "weight_min"):
            assert td[n].dtype == torch.float32
            np.testing.assert_allclose(float(td[n]), float(jd[n]), rtol=1e-6, err_msg=n)
        else:
            assert td[n].dtype == torch.int32 and td[n].dim() == 0
            assert int(td[n]) == int(jd[n]), n


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_degenerate_async_is_the_sync_round_bit_for_bit(name):
    """``buffer_m=K``, zero delays, constant weighting: three ticks give
    the sync round's params, metrics, aggregator and attack state, bit for
    bit, for every registered aggregator (``tests/test_asyncfl.py:69-105``);
    every tick fires with staleness 0."""
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(1))
    kw = {}
    if name == "fltrust":
        kw["trusted_mask"] = torch.arange(6) == 5
    sync = _port(params, spec, name, k=6, f=2, **kw)
    asy = _port(params, spec, name, AsyncConfig(buffer_m=6, staleness="constant"), k=6, f=2,
                **kw)
    ss, sa = sync.init(params), asy.init(params)
    for rnd in range(3):
        cx, cy = (torch.from_numpy(a) for a in _batches(rnd, 6))
        ss, ms = sync.run_round(ss, cx, cy, CLIENT_LR, SERVER_LR, seed=2)
        sa, ma = asy.run_round(sa, cx, cy, CLIENT_LR, SERVER_LR, seed=2)
        for field in RoundMetrics._fields:
            assert torch.equal(getattr(ms, field), getattr(ma, field)), field
        assert torch.equal(asy.last_updates, sync.last_updates)
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(ss._replace(async_state=())), leaves(sa._replace(async_state=()))):
        assert (a == b) if not isinstance(a, torch.Tensor) else torch.equal(a, b)
    d = asy.last_async_diag
    assert int(d["fired"]) == 1 and int(d["fires_total"]) == 3
    assert float(d["mean_staleness"]) == 0.0 and int(d["aggregated"]) == 6


@pytest.mark.parametrize("name", ["trimmedmean", "mean", "asyncmean", "centeredclipping"])
def test_degenerate_async_matches_jax(jax_params, name):
    """The degenerate configuration, three K=10 ticks against the JAX async
    engine: ``TOL_N``, the counters exactly."""
    cfg = dict(buffer_m=K, staleness="constant")
    jeng = _jax(jax_params, name, cfg)
    tspec = create_mnist_model()
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = _port(tparams, tspec, name, AsyncConfig(**cfg))
    jstate, tstate = jeng.init(jax_params), teng.init(tparams)
    for rnd in range(3):
        cx, cy = _batches(rnd)
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR)
    _check_tick(jeng, jstate, teng, tstate, jm, tm, TOL_N)


FIXED = (0, 1, 2, 0, 1, 2, 0, 1, 2, 0)


@pytest.mark.parametrize("name", ["trimmedmean", "mean", "asyncmean", "asynccenteredclipping"])
def test_fixed_delays_match_jax(jax_params, name):
    """Fixed delays (0, 1, 2, ...), ``buffer_m=5`` (the four delay-0
    clients alone do not fire it), polynomial weighting
    (alpha 0.5), ALIE f=4, four K=10 ticks against the JAX async engine:
    the params, every field of ``async_state`` (the integer ones exactly),
    the 10 counters (the counts exactly). Each tick is held at one tick's
    ``TOL`` from JAX's state carried into the port, and the run at
    ``TOL_N`` without it."""
    cfg = dict(buffer_m=5, arrivals=dict(kind="fixed", delays=FIXED), staleness="polynomial",
               alpha=0.5)
    jeng = _jax(jax_params, name, cfg)
    tspec = create_mnist_model()
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = _port(tparams, tspec, name, AsyncConfig(**cfg))
    jstate, tstate = jeng.init(jax_params), teng.init(tparams)
    fired = []
    for rnd in range(4):
        cx, cy = _batches(rnd)
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR)
        _check_tick(jeng, jstate, teng, tstate, jm, tm, TOL_N)
        np.testing.assert_allclose(teng.last_updates.numpy(), np.asarray(jeng.last_updates),
                                   **TOL_N)
        fired.append(int(teng.last_async_diag["fired"]))
    # the warm tick fires; the staggered ticks wait for 4 arrivals
    assert fired[0] == 1 and 0 in fired[1:] and 1 in fired[1:]
    assert "hist" in tstate.async_state and tstate.async_state["hist"].shape == (3, D)


def _carry(jstate, tstate, layout):
    """The port's state with the JAX state's params, async state and
    aggregator state carried in."""
    from blades_tpu_torch.models import state_from_jax

    return tstate._replace(params=params_from_jax(jstate.params, layout),
                           async_state=state_from_jax(dict(jstate.async_state)),
                           agg_state=state_from_jax(jstate.agg_state))


def _inject_draws(jeng, teng, seed, rnd):
    """Hand the port's arrival draws of tick ``rnd`` to ``jeng``."""
    draws = _arrival_draws(teng.async_config.arrivals, seed, rnd, K)
    object.__setattr__(jeng.async_config.arrivals, "draw",
                       lambda key, k: jnp.asarray(draws.numpy()))
    return draws


@pytest.mark.parametrize("arrivals", [dict(kind="uniform", max_delay=2),
                                      dict(kind="geometric", mean_delay=1.0, max_delay=3)],
                         ids=["uniform", "geometric"])
@pytest.mark.parametrize("name", ["trimmedmean", "median"])
def test_random_arrivals_match_jax(jax_params, name, arrivals):
    """Uniform and geometric arrivals, ``buffer_m=3``, polynomial
    weighting, four K=10 ticks: the port's draws handed to a fresh JAX
    engine each tick, JAX's state carried into the port before each tick
    (so each is held at one tick's ``TOL``), the counters exactly."""
    cfg = dict(buffer_m=3, arrivals=arrivals, staleness="polynomial", alpha=0.5)
    tspec = create_mnist_model()
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = _port(tparams, tspec, name, AsyncConfig(**cfg))
    jstate, tstate = _jax(jax_params, name, cfg).init(jax_params), teng.init(tparams)
    seen = set()
    for rnd in range(4):
        jeng = _jax(jax_params, name, cfg)
        draws = _inject_draws(jeng, teng, 3, rnd)
        seen |= set(draws.tolist())
        tstate = _carry(jstate, tstate, tspec.layout)
        cx, cy = _batches(rnd)
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR, seed=3)
        _check_tick(jeng, jstate, teng, tstate, jm, tm, TOL)
    assert len(seen) > 1


def test_async_under_dropout_matches_jax(jax_params, monkeypatch):
    """Uniform arrivals under ``FaultModel(dropout_rate=0.3)``, four K=10
    ticks: a dropped arrival is lost; the fault draws and the arrival
    draws the port's, handed to a fresh JAX engine each tick."""
    cfg = dict(buffer_m=3, arrivals=dict(kind="uniform", max_delay=2), staleness="polynomial")
    faults = dict(dropout_rate=0.3)
    tspec = create_mnist_model()
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = _port(tparams, tspec, "trimmedmean", AsyncConfig(**cfg),
                 fault_model=FaultModel(**faults))
    jstate, tstate = _jax(jax_params, "trimmedmean", cfg, faults).init(jax_params), teng.init(
        tparams)
    lost = 0
    for rnd in range(4):
        jeng = _jax(jax_params, "trimmedmean", cfg, faults)
        _inject_draws(jeng, teng, 5, rnd)
        fd = draw_faults(teng.fault_model, K, D, port_rng.generator(5, rnd, port_rng.FAULT))
        queue = [fd["drop"].numpy()]
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p=0.5, shape=None: jnp.asarray(queue.pop(0)))
        tstate = _carry(jstate, tstate, tspec.layout)
        cx, cy = _batches(rnd)
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR, seed=5)
        assert queue == []
        _check_tick(jeng, jstate, teng, tstate, jm, tm, TOL)
        assert {n: int(v) for n, v in teng.last_fault_diag.items()} == {
            n: int(v) for n, v in jeng.last_fault_diag.items()}
        d = teng.last_async_diag
        assert int(d["deposited"]) <= int(d["arrivals"])
        lost += int(d["arrivals"]) - int(d["deposited"])
    assert lost > 0


def test_tick_without_fire_leaves_model_and_states_untouched():
    """``buffer_m=K`` and delays (1, 2, 3, ...): after the warm tick fires,
    no tick reaches K arrivals. Such a tick leaves the params, the server's
    momentum and centered clipping's momentum bit-identical and applies the
    zero update, while the buffer fills."""
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(2))
    eng = _port(params, spec, "centeredclipping",
                AsyncConfig(buffer_m=K, arrivals=dict(kind="fixed", delays=(1, 2, 3) * 3 + (1,))),
                server_opt=ServerOptSpec(momentum=0.9))
    state = eng.init(params)
    cx, cy = (torch.from_numpy(a) for a in _batches(0))
    state, _ = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR)
    assert int(eng.last_async_diag["fired"]) == 1
    before = state
    for rnd in range(1, 3):
        cx, cy = (torch.from_numpy(a) for a in _batches(rnd))
        state, m = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR)
        assert int(eng.last_async_diag["fired"]) == 0 and float(m.agg_norm) == 0.0
    for a, b in zip(*(torch.utils._pytree.tree_leaves((s.params, s.server_opt_state,
                                                       s.agg_state)) for s in (before, state))):
        assert torch.equal(a, b)
    assert int(eng.last_async_diag["buffer_count"]) > 0
    assert int(state.async_state["fires"]) == 1


def test_cutoff_excludes_stale_rows():
    """Cutoff 1 with one client 3 ticks late: at every later fire its
    buffered update is excluded and counted, the rest aggregated."""
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(3))
    eng = _port(params, spec, "mean",
                AsyncConfig(buffer_m=K, arrivals=dict(kind="fixed", delays=(0,) * 9 + (3,)),
                            staleness="cutoff", cutoff=1), f=0)
    state = eng.init(params)
    fires = 0
    for rnd in range(5):
        cx, cy = (torch.from_numpy(a) for a in _batches(rnd))
        state, _ = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR)
        d = eng.last_async_diag
        if rnd and int(d["fired"]):
            fires += 1
            assert int(d["stale_excluded"]) >= 1 and int(d["max_staleness"]) <= 1
            assert int(d["aggregated"]) == K - int(d["stale_excluded"])
            assert 0 <= int(d["stale_excluded"]) <= int(d["buffer_count"])
    assert fires >= 1


def test_version_lagged_training_starts_from_the_downloaded_model():
    """Client 9 lags 2 ticks: it downloads version 1 at the warm tick and
    arrives at tick 3, and its row there is what a sync engine computes for
    it from the params after tick 0 (its download), on tick 3's batch and
    seed (the round index forced to 3)."""
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(4))
    eng = _port(params, spec, "mean",
                AsyncConfig(buffer_m=1, arrivals=dict(kind="fixed", delays=(0,) * 9 + (2,))),
                f=0)
    state = eng.init(params)
    after = {}
    for rnd in range(4):
        cx, cy = (torch.from_numpy(a) for a in _batches(rnd))
        state, _ = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR, seed=1)
        after[rnd] = {n: t.clone() for n, t in state.params.items()}
    lagged = eng.last_updates[9]
    assert int(state.async_state["version"][9]) == 4
    sync = _port(after[0], spec, "mean", f=0)
    sstate = sync.init(after[0])._replace(round_idx=3)
    sync.run_round(sstate, cx, cy, CLIENT_LR, SERVER_LR, seed=1)
    torch.testing.assert_close(lagged, sync.last_updates[9], rtol=1e-6, atol=1e-7)
    # and not what it would compute from the live params
    live = _port(after[2], spec, "mean", f=0)
    live.run_round(live.init(after[2])._replace(round_idx=3), cx, cy, CLIENT_LR, SERVER_LR,
                   seed=1)
    assert not torch.allclose(lagged, live.last_updates[9], rtol=1e-3, atol=1e-6)


def test_persistent_adam_keeps_the_rows_of_clients_that_did_not_arrive(jax_params):
    """Adam with ``persist=True`` under fixed delays, three K=10 ticks in 2
    chunks, against JAX: a client's state moves only on the ticks it
    arrives (its count counts those), and the rows of the others are
    bit-identical to the tick before."""
    cfg = dict(buffer_m=4, arrivals=dict(kind="fixed", delays=FIXED))
    opt = dict(name="adam", persist=True)
    jeng = _jax(jax_params, "trimmedmean", cfg, client_opt=opt, chunks=2)
    tspec = create_mnist_model()
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = _port(tparams, tspec, "trimmedmean", AsyncConfig(**cfg),
                 client_opt=ClientOptSpec(**opt), client_chunks=2)
    jstate, tstate = jeng.init(jax_params), teng.init(tparams)
    for rnd in range(3):
        prev = tstate.client_opt_state
        arriving = (tstate.async_state["countdown"] <= 0)
        cx, cy = _batches(rnd)
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR)
        count, mu, nu = tstate.client_opt_state[-1]
        np.testing.assert_array_equal(count.numpy(),
                                      np.asarray(jstate.client_opt_state[-1].count))
        for new, old in zip(torch.utils._pytree.tree_leaves(tstate.client_opt_state),
                            torch.utils._pytree.tree_leaves(prev)):
            assert torch.equal(new[~arriving], old[~arriving])
            if rnd and new.dtype.is_floating_point:
                assert not torch.equal(new[arriving], old[arriving])
        rows = jax.vmap(lambda t: ravel_pytree(t)[0])
        np.testing.assert_allclose(teng._ravel_rows(mu).numpy(),
                                   np.asarray(rows(jstate.client_opt_state[-1].mu)), **TOL_N)
    assert count.tolist() == [3, 2, 1, 3, 2, 1, 3, 2, 1, 3]


# -- the engine and the Simulator ------------------------------------------------------


def test_build_checks_match_jax():
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(0))
    cfg = AsyncConfig(buffer_m=50)
    with pytest.raises(ValueError, match="streaming"):
        _port(params, spec, "mean", cfg, streaming=True)
    with pytest.raises(ValueError, match="requires an aggregator"):
        RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                    num_clients=K, device="cpu", async_config=cfg)
    with pytest.raises(ValueError, match="straggler"):
        _port(params, spec, "mean", cfg, fault_model=FaultModel(straggler_rate=0.1))
    assert _port(params, spec, "mean", cfg).async_buffer_m == K
    eng = _port(params, spec, "mean", AsyncConfig(buffer_m=3, arrivals=dict(
        kind="uniform", max_delay=2)))
    assert eng.async_buffer_m == 3
    state = eng.init(params)
    assert state.async_state["hist"].shape == (3, D) and state.client_opt_state == ()
    # a sync engine carries no async state and sets no counters
    sync = _port(params, spec, "mean")
    assert sync.init(params).async_state == () and sync.last_async_diag is None


def test_simulator_runs_async_from_a_dict(tmp_path):
    """``run(async_config={...})``: the dict becomes an ``AsyncConfig``
    (its ``arrivals`` an ``ArrivalProcess``), the rounds run, and the last
    tick's counters are on the engine."""
    ds = Synthetic(num_clients=8, train_size=400, test_size=80, cache=False)
    sim = Simulator(ds, attack="alie", num_byzantine=2, aggregator="asynccenteredclipping",
                    device="cpu", log_path=str(tmp_path))
    times = sim.run("mlp", global_rounds=3, train_batch_size=8,
                    async_config={"buffer_m": 4, "arrivals": {"kind": "uniform",
                                                              "max_delay": 2},
                                  "staleness": "polynomial"})
    assert len(times) == 3
    cfg = sim.engine.async_config
    assert isinstance(cfg, AsyncConfig) and isinstance(cfg.arrivals, ArrivalProcess)
    d = sim.engine.last_async_diag
    assert set(d) == set(DIAG) and int(d["fires_total"]) >= 1
    assert sim.server.state.round_idx == 3
