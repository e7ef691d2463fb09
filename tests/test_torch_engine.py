"""One MLP round, and one CCT-2 round, of the port against
``blades_tpu.core.RoundEngine``.

Every attack and dense aggregator of the catalog runs one K=10 MLP round
against the JAX engine: each new attack with trimmed mean, each new
aggregator with ALIE (f=4). The noise attack's normals and DnC's draws are
the port's, handed to the JAX package by patching ``jax.random.normal`` and
``jax.random.choice``; for DnC the JAX round then runs eagerly
(``jax.disable_jit``) so that each DnC iteration takes its own draw.

Under a fault model (dropout, stragglers, NaN clients) each registered
aggregator runs two K=10 MLP rounds, the second replaying a straggler, and
one K=6 CCT-2 round runs under dropout with trimmed mean. The fault draws
are the port's (``faults.draw_faults`` on the round's ``FAULT``
generator), handed to ``jax.random.bernoulli`` in call order; each round
builds a fresh JAX engine, so its jitted round traces again and takes that
round's draws.

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
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.core import ClientOptSpec as JaxClientOptSpec
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.core import ServerOptSpec as JaxServerOptSpec
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu_torch.aggregators import Trimmedmean, get_aggregator
from blades_tpu_torch.aggregators.dnc import draw_subspaces
from blades_tpu_torch.attackers import Alie, get_attack
from blades_tpu_torch.attackers.noise import draw_normals
from blades_tpu_torch.core import ClientOptSpec, RoundEngine, RoundMetrics, ServerOptSpec
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.models import build_fns, cct, create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.utils import rng as port_rng

K, F, S, B = 10, 4, 2, 8
CLIENT_LR, SERVER_LR = 0.1, 1.0
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_3 = dict(rtol=1e-3, atol=1e-5)


def _batches(rnd):
    rng = np.random.RandomState(100 + rnd)
    cx = rng.randn(K, S, B, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (K, S, B)).astype(np.int32)
    return cx, cy


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _engines(jax_params, client_chunks, attack=None, aggregator=None, trusted=None,
             faults=None, client_opt=None, server_opt=None):
    """The two engines; ``attack`` / ``aggregator``: ``(name, kwargs)`` for
    both registries (default ALIE and trimmed mean b=5); ``faults``: the
    kwargs of a fault model for both; ``client_opt`` / ``server_opt``: the
    kwargs of both packages' optimizer specs (default plain SGD)."""
    opts = dict(client_opt=(JaxClientOptSpec(**client_opt), ClientOptSpec(**client_opt))
                if client_opt else (JaxClientOptSpec(), ClientOptSpec()),
                server_opt=(JaxServerOptSpec(**server_opt), ServerOptSpec(**server_opt))
                if server_opt else (JaxServerOptSpec(), ServerOptSpec()))
    jspec, tspec = jax_mlp(), create_mnist_model()
    if attack is None:
        jattack, tattack = JaxAlie(num_clients=K, num_byzantine=F), Alie(num_clients=K,
                                                                           num_byzantine=F)
    else:
        jattack, tattack = jax_get_attack(*attack[:1], **attack[1]), get_attack(
            *attack[:1], **attack[1])
    if aggregator is None:
        jagg, tagg = JaxTrimmedmean(num_byzantine=5), Trimmedmean(num_byzantine=5)
    else:
        jagg = jax_get_aggregator(aggregator[0], **aggregator[1])
        tagg = get_aggregator(aggregator[0], **aggregator[1])
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jax_params,
        num_clients=K, num_byzantine=F, attack=jattack, aggregator=jagg,
        trusted_mask=None if trusted is None else jnp.asarray(trusted),
        plan=None, client_chunks=client_chunks, keep_updates=True,
        fault_model=None if faults is None else JaxFaultModel(**faults),
        **{n: pair[0] for n, pair in opts.items()},
    )
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = RoundEngine(
        tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout,
        num_clients=K, num_byzantine=F, attack=tattack, aggregator=tagg,
        trusted_mask=None if trusted is None else torch.from_numpy(trusted),
        client_chunks=client_chunks, keep_updates=True, device="cpu",
        fault_model=None if faults is None else FaultModel(**faults),
        **{n: pair[1] for n, pair in opts.items()},
    )
    jstate = jeng.init(jax_params)
    tstate = teng.init(tparams)
    return (jeng, jstate), (teng, tstate, tspec.layout)


def _round(jax_side, torch_side, rnd, seed=0):
    (jeng, jstate), (teng, tstate, layout) = jax_side, torch_side
    cx, cy = _batches(rnd)
    jstate, jm = jeng.run_round(
        jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR, SERVER_LR,
        jax.random.PRNGKey(7),
    )
    tstate, tm = teng.run_round(
        tstate, torch.from_numpy(cx), torch.from_numpy(cy), CLIENT_LR, SERVER_LR, seed=seed
    )
    return (jeng, jstate), (teng, tstate, layout), jm, tm


def _check_metrics(jm, tm, rtol):
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else 1e-5
        np.testing.assert_allclose(
            float(getattr(tm, name)), float(getattr(jm, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )


def _flat_params(jstate, tstate, layout):
    return ravel(tstate.params, layout).numpy(), np.asarray(ravel_pytree(jstate.params)[0])


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


# -- the attack and defense catalog -------------------------------------------

ATTACK_CASES = [("ipm", {}), ("signflipping", {}), ("labelflipping", {"num_classes": 10}),
                ("noise", {}), ("minmax", {}), ("minsum", {})]
AGG_CASES = [("median", {}), ("krum", {"num_byzantine": F}),
             ("multikrum", {"num_byzantine": F, "num_selected": 3}), ("geomed", {}),
             ("autogm", {}), ("centeredclipping", {}), ("clustering", {}),
             ("clustering", {"metric": "distance"}), ("clippedclustering", {}), ("fltrust", {}),
             ("dnc", {"num_byzantine": F})]


def _catalog_id(case):
    kind, (name, kw) = case
    return "-".join([kind, name, *(f"{a}{b}" for a, b in kw.items() if a != "num_byzantine")])


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


# -- CCT-2 ---------------------------------------------------------------------

CCT_K, CCT_F, CCT_S, CCT_B = 6, 2, 1, 4
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)


def _cct_batches(seed):
    rng = np.random.RandomState(seed)
    cx = rng.randn(CCT_K, CCT_S, CCT_B, 32, 32, 3).astype(np.float32)
    cy = rng.randint(0, 10, (CCT_K, CCT_S, CCT_B)).astype(np.int32)
    return cx, cy


def _cct_engine(spec, params, client_chunks=1, attack=None, aggregator=None):
    return RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
        num_clients=CCT_K, num_byzantine=CCT_F,
        attack=attack or Alie(num_clients=CCT_K, num_byzantine=CCT_F),
        aggregator=aggregator or Trimmedmean(num_byzantine=2), client_chunks=client_chunks,
        keep_updates=True, device="cpu", noise_sites=spec.noise_sites,
    )


@pytest.mark.parametrize("attack,aggregator", [
    ("alie", ("trimmedmean", {"num_byzantine": 2})),
    ("signflipping", ("median", {})),
])
def test_cct2_round_matches_jax(attack, aggregator):
    """One CCT-2 round (D = 283,723), ALIE + trimmed mean b=2 and sign
    flipping + median, with attention dropout and stochastic depth at 0 on
    both sides (the two packages draw different bits), within the file's
    ``TOL``."""
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), (32, 32, 3))
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tspec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    attack_kws = dict(num_clients=CCT_K, num_byzantine=CCT_F) if attack == "alie" else {}
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams,
        num_clients=CCT_K, num_byzantine=CCT_F,
        attack=jax_get_attack(attack, **attack_kws),
        aggregator=jax_get_aggregator(aggregator[0], **aggregator[1]), plan=None,
        keep_updates=True,
    )
    tparams = params_from_jax(jparams, tspec.layout)
    teng = _cct_engine(tspec, tparams, attack=get_attack(attack, **attack_kws),
                       aggregator=get_aggregator(aggregator[0], **aggregator[1]))
    cx, cy = _cct_batches(200)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx),
                                torch.from_numpy(cy), CLIENT_LR, SERVER_LR)
    tu = teng.last_updates
    assert tu.shape == (CCT_K, 283_723)
    np.testing.assert_allclose(tu.numpy(), np.asarray(jeng.last_updates), **TOL)
    np.testing.assert_allclose(*_flat_params(jstate, tstate, tspec.layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])


def test_cct2_round_at_default_rates_does_not_depend_on_chunks():
    """At CCT-2's default rates the masks are drawn for all K clients before
    the chunk split, so 1 and 3 chunks run the same round: the same masks,
    and the same math up to the batch size of the vmapped calls (f32,
    ``rtol=1e-5, atol=1e-7``)."""
    spec = build_fns(cct.cct_2_3x2_32())
    assert spec.noise_sites(CCT_B)  # the round draws masks
    params = spec.init(torch.Generator().manual_seed(4))
    cx, cy = (torch.from_numpy(a) for a in _cct_batches(201))
    out = []
    for chunks in (1, 3):
        eng = _cct_engine(spec, params, client_chunks=chunks)
        state, m = eng.run_round(eng.init(params), cx, cy, CLIENT_LR, SERVER_LR, seed=3)
        out.append((eng.last_updates, ravel(state.params, spec.layout), float(m.train_loss)))
    (u1, p1, l1), (u3, p3, l3) = out
    torch.testing.assert_close(u3, u1, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(p3, p1, rtol=1e-5, atol=1e-7)
    assert l3 == pytest.approx(l1, rel=1e-6)
    # another seed draws other masks
    eng = _cct_engine(spec, params)
    eng.run_round(eng.init(params), cx, cy, CLIENT_LR, SERVER_LR, seed=4)
    assert not torch.allclose(eng.last_updates, u1, rtol=1e-3, atol=1e-5)


# -- fault rounds --------------------------------------------------------------

FAULTS = dict(dropout_rate=0.3, straggler_rate=0.2, corrupt_clients=(1, 2))
FAULT_SEED = 3  # the port's root seed: round 2 replays client 5's round-1 update
FAULT_AGGS = [("mean", {}), ("trimmedmean", {"num_byzantine": 5}), ("median", {}),
              ("krum", {"num_byzantine": F}),
              ("multikrum", {"num_byzantine": F, "num_selected": 3}), ("geomed", {}),
              ("autogm", {}), ("centeredclipping", {}), ("clustering", {}),
              ("clippedclustering", {}), ("fltrust", {}), ("byzantinesgd", {}),
              ("dnc", {"num_byzantine": F}), ("signguard", {})]


def _queue_fault_draws(monkeypatch, fm, dim, seed, rnd):
    """The port's fault draws of round ``rnd``, queued for the JAX package's
    ``jax.random.bernoulli``; returns the queue (empty once taken)."""
    draws = draw_faults(fm, K if dim == 59_850 else CCT_K, dim,
                        port_rng.generator(seed, rnd, port_rng.FAULT))
    queue = [draws[n].numpy() for n in ("drop", "straggle", "corrupt", "bitflip")
             if draws[n] is not None]

    def bernoulli(key, p=0.5, shape=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return queue


def _check_fault_round(jeng, jstate, teng, tstate, layout, jm, tm):
    ju, tu = np.asarray(jeng.last_updates), teng.last_updates
    np.testing.assert_allclose(tu.numpy(), ju, **TOL)  # NaN rows in both
    assert {n: int(v) for n, v in teng.last_fault_diag.items()} == {
        n: int(v) for n, v in jeng.last_fault_diag.items()}
    np.testing.assert_allclose(*_flat_params(jstate, tstate, layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])
    for n in ("stale", "age", "has"):
        np.testing.assert_allclose(tstate.fault_state[n].numpy(),
                                   np.asarray(jstate.fault_state[n]), **TOL)


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


# -- client and server optimizers; persistent client state ----------------------

MOMENTUM = dict(name="sgd", momentum=0.9, weight_decay=1e-2)
ADAM = dict(name="adam")
# Adam's step g / (sqrt(nu_hat) + 1e-8) turns the two frameworks' rounding
# in a near-zero gradient into a step of order lr: its params are held
# where every client's sqrt(nu_hat) exceeds this (in JAX's state)
ADAM_WELL_CONDITIONED = 1e-6
_rows = jax.vmap(lambda t: ravel_pytree(t)[0])


# a server step's rounding is about 1e-4 of lr, so TOL_3 holds steps above
# a tenth of lr
ADAM_NO_CANCELLATION = 0.1


def _well_conditioned(adam_state, no_cancellation=False):
    """The ``[D]`` coordinates where ``sqrt(nu_hat)`` of a JAX Adam state
    exceeds ``ADAM_WELL_CONDITIONED`` (every client's, for a stacked one)
    and, with ``no_cancellation``, ``|mu_hat|`` exceeds
    ``ADAM_NO_CANCELLATION * sqrt(nu_hat)``."""
    count = np.asarray(adam_state.count, np.float64)
    flat = _rows if count.ndim else (lambda t: ravel_pytree(t)[0])
    if count.ndim:  # stacked [K] client states
        count = count[:, None]
    nu_hat = np.sqrt(np.asarray(flat(adam_state.nu)) / (1 - 0.999 ** count))
    ok = nu_hat > ADAM_WELL_CONDITIONED
    if no_cancellation:
        mu_hat = np.asarray(flat(adam_state.mu)) / (1 - 0.9 ** count)
        ok &= np.abs(mu_hat) > ADAM_NO_CANCELLATION * nu_hat
    return np.atleast_2d(ok).all(axis=0)


def _check_client_state(teng, tstate, jstate):
    """The port's persistent client state against JAX's, client by client:
    momentum's trace, or Adam's count (exact), first and second moments."""
    tpart, jpart = tstate.client_opt_state[-1], jstate.client_opt_state[-1]
    if isinstance(tpart, dict):  # optax.trace
        np.testing.assert_allclose(teng._ravel_rows(tpart).numpy(),
                                   np.asarray(_rows(jpart.trace)), **TOL_3)
        return
    count, mu, nu = tpart
    np.testing.assert_array_equal(count.numpy(), np.asarray(jpart.count))
    assert count.dtype == torch.int32 and count.shape == (K,)
    np.testing.assert_allclose(teng._ravel_rows(mu).numpy(), np.asarray(_rows(jpart.mu)),
                               **TOL_3)
    np.testing.assert_allclose(teng._ravel_rows(nu).numpy(), np.asarray(_rows(jpart.nu)),
                               **TOL_3)


@pytest.mark.parametrize("client_chunks", [1, 3])
def test_persistent_momentum_three_rounds_match_jax(jax_params, client_chunks):
    """Momentum SGD with weight decay and ``persist=True``, three K=10
    rounds: the params, the metrics and every client's trace agree with
    the JAX engine's ``state.client_opt_state`` at ``TOL_3``."""
    j, t = _engines(jax_params, client_chunks, client_opt=dict(MOMENTUM, persist=True))
    for rnd in range(3):
        j, t, jm, tm = _round(j, t, rnd)
        _check_metrics(jm, tm, rtol=TOL_3["rtol"])
        _check_client_state(t[0], t[1], j[1])
    np.testing.assert_allclose(*_flat_params(j[1], t[1], t[2]), **TOL_3)
    trace = t[1].client_opt_state[-1]
    assert next(iter(trace.values())).shape[0] == K


@pytest.mark.parametrize("client_chunks", [1, 3])
def test_persistent_adam_three_rounds_match_jax(jax_params, client_chunks):
    """Adam with ``persist=True``, three K=10 rounds. Adam's moments and
    counts are linear and quadratic in the gradients and are held at
    ``TOL_3`` for every client; the params at ``TOL_3`` on the coordinates
    where every client's ``sqrt(nu_hat)`` exceeds 1e-6 (3,166 of the 59,850
    leave that set at this seed: coordinates where a client's gradient
    stays near zero; ``ROADMAP.md``, behaviours to know)."""
    j, t = _engines(jax_params, client_chunks, client_opt=dict(ADAM, persist=True))
    for rnd in range(3):
        j, t, jm, tm = _round(j, t, rnd)
        _check_client_state(t[0], t[1], j[1])
    assert np.asarray(t[1].client_opt_state[-1][0]).tolist() == [3 * S] * K
    ok = _well_conditioned(j[1].client_opt_state[-1])
    assert ok.size - ok.sum() == 3_166
    tp, jp = _flat_params(j[1], t[1], t[2])
    np.testing.assert_allclose(tp[ok], jp[ok], **TOL_3)
    assert np.isfinite(tp).all()


def _carry_into_port(jstate, tstate, layout):
    """The port's state with the JAX state's params and, for a server Adam,
    its moments and count."""
    server = tstate.server_opt_state
    if server and isinstance(server[-1], tuple):
        adam = jstate.server_opt_state[-1]
        server = server[:-1] + ((torch.tensor(np.asarray(adam.count)),
                                 params_from_jax(adam.mu, layout),
                                 params_from_jax(adam.nu, layout)),)
    return tstate._replace(params=params_from_jax(jstate.params, layout), server_opt_state=server)


@pytest.mark.parametrize("opt", [MOMENTUM, ADAM], ids=["momentum", "adam"])
@pytest.mark.parametrize("side", ["client", "server"])
def test_non_persistent_optimizer_rounds_match_jax(jax_params, side, opt):
    """Momentum SGD with weight decay and Adam, on the client (a fresh
    state each round) or on the server, three K=10 rounds.

    Momentum: the trajectory, the metrics too, at ``TOL_3``. Adam: each
    round from JAX's state carried into the port, the round's step (the new
    params less the carried ones: a step of order lr can land a param near
    zero, where its own relative error is no measure) at ``TOL_3`` on the
    coordinates where Adam's direction ``mu_hat / sqrt(nu_hat)`` is well
    conditioned in JAX's state: ``sqrt(nu_hat)`` above 1e-6 and, on the
    server, ``|mu_hat|`` above ``ADAM_NO_CANCELLATION * sqrt(nu_hat)`` (a
    new gradient that cancels the first moment leaves a small step made of
    rounding). The client side takes one local step a round: a client's
    first Adam step is ``g / (|g| + eps)``, of order lr however small ``g``
    is, so one near-zero gradient changes all its later steps; its
    ``nu_hat`` is every client's, read from a JAX engine with
    ``persist=True`` run on the same round (its fresh state is the one the
    round starts from). Across rounds Adam is not held: its first server
    step moves every coordinate by ``server_lr`` in the sign of the
    aggregate, so an aggregate within rounding of zero sends the two
    trajectories apart."""
    adam = opt == ADAM
    j, t = _engines(jax_params, 2, **{f"{side}_opt": opt})
    steps = 1 if adam and side == "client" else S
    excluded = []
    for rnd in range(3):
        cx, cy = (a[:, :steps] for a in _batches(rnd))
        if adam:
            t = (t[0], _carry_into_port(j[1], t[1], t[2]), t[2])
        if adam and side == "client":
            (twin, tstate), _ = _engines(jax_params, 2, client_opt=dict(ADAM, persist=True))
            start = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), j[1].params)
            tstate, _ = twin.run_round(tstate._replace(params=start), jnp.asarray(cx),
                                       jnp.asarray(cy), CLIENT_LR, SERVER_LR,
                                       jax.random.PRNGKey(7))
            ok = _well_conditioned(tstate.client_opt_state[-1])
        before = _flat_params(j[1], t[1], t[2])[1]
        jstate, jm = j[0].run_round(j[1], jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = t[0].run_round(t[1], torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR)
        j, t = (j[0], jstate), (t[0], tstate, t[2])
        tp, jp = _flat_params(j[1], t[1], t[2])
        if adam:
            if side == "server":
                ok = _well_conditioned(jstate.server_opt_state[-1], no_cancellation=True)
                # the aggregate the server stepped with, before Adam
                np.testing.assert_allclose(float(tm.agg_norm), float(jm.agg_norm),
                                           rtol=TOL["rtol"])
            excluded.append(int(ok.size - ok.sum()))
            np.testing.assert_allclose((tp - before)[ok], (jp - before)[ok], **TOL_3)
        else:
            _check_metrics(jm, tm, rtol=TOL_3["rtol"])
    assert t[1].client_opt_state == ()
    if adam:
        assert max(excluded) < 0.8 * tp.size, excluded
    else:
        np.testing.assert_allclose(tp, jp, **TOL_3)
    assert np.isfinite(tp).all()


@pytest.mark.parametrize("lead", [(), (K,)], ids=["server", "stacked-clients"])
@pytest.mark.parametrize("spec", [MOMENTUM, ADAM, dict(ADAM, weight_decay=1e-2)],
                         ids=["momentum", "adam", "adamw"])
def test_optimizer_transforms_match_optax(spec, lead):
    """The port's optax chains on the same seeded gradients and params,
    four updates, against optax's (vmapped over a stacked client axis):
    the updates and every state leaf, the count exactly."""
    import optax  # noqa: F401  (the JAX side's optimizer library)

    rng = np.random.RandomState(9)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {n: rng.randn(*lead, *sh).astype(np.float32) for n, sh in shapes.items()}
    ours = ClientOptSpec(**spec).transform()
    ref = JaxClientOptSpec(**spec).transform()
    tstate = ours.init({n: torch.from_numpy(a) for n, a in params.items()}, lead=lead)
    jinit = jax.vmap(ref.init) if lead else ref.init
    jupdate = jax.vmap(ref.update) if lead else ref.update
    jstate = jinit({n: jnp.asarray(a) for n, a in params.items()})
    for step in range(4):
        # one gradient row near zero: Adam's g / (|g| + eps) with |g| ~ eps
        grads = {n: (rng.randn(*lead, *sh) * (10.0 ** -step)).astype(np.float32)
                 for n, sh in shapes.items()}
        tu, tstate = ours.update({n: torch.from_numpy(g) for n, g in grads.items()}, tstate,
                                 {n: torch.from_numpy(a) for n, a in params.items()})
        ju, jstate = jupdate({n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                             {n: jnp.asarray(a) for n, a in params.items()})
        for n in shapes:
            np.testing.assert_allclose(tu[n].numpy(), np.asarray(ju[n]), rtol=1e-5, atol=1e-7)
    tleaves = torch.utils._pytree.tree_leaves(tstate)
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        if np.asarray(b).dtype.kind == "i":
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.shape == tuple(lead)
