"""The port's streaming round against the JAX package's streaming round.

Covered: the registry's split (13 streaming defenses with the async pair,
3 opt-outs with the JAX package's reasons, and asynchronous centered
clipping's with ``n_iter > 1``); every streaming
defense's ``aggregate_streaming`` at 1, 2 and 3 chunks of K=7 rows (2 and
3 chunks pad the final chunk), with and without a mask, against JAX's;
masked-out garbage and zero participants; three rounds of centered
clipping's momentum and clipped clustering's ring; ``plan_streaming`` and
``corrupt_chunk``; the engine's build-time validation; K=7 MLP streaming
rounds (2 chunks, pad 1) under sign flipping, label flipping and noise,
with and without a fault model, and one round with each streaming defense;
a K=6 CCT-2 streaming round; the exact forms' streaming rounds against the
port's dense rounds; persistent client state (``persist=True``) through
the streaming round.

The JAX streaming round draws per chunk (the noise attack's normals and the
bit-flip pattern, from ``fold_in(key, chunk)``). The port draws them from
its per-chunk generators (``utils/rng.py``, ``chunk=``), and the tests hand
those draws to ``jax.random.normal`` / ``jax.random.bernoulli`` in call
order, with the JAX round run eagerly (``jax.disable_jit``) so that its
chunk scan calls them once a chunk. The streaming fault plan's ``[K]``
draws are the port's ``draw_faults`` with ``dim=None``.

Tolerances: ``aggregate_streaming`` f32 ``rtol=atol=1e-5``, GeoMed and
AutoGM ``rtol=1e-4, atol=1e-6``; rounds ``rtol=1e-4, atol=1e-5`` (the
variance metrics ``atol=1e-12``), as in ``tests/test_torch_engine.py``.
Streaming is compared with streaming: the JAX package's own two-level
trimmed mean drifts from its dense one (``ROADMAP.md`` queue C). The exact
forms (mean, centered clipping with ``n_iter=1``) are also held to the
port's dense round, at f32 ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators import AGGREGATORS as JAX_AGGREGATORS
from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.core import ClientOptSpec as JaxClientOptSpec
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu.ops import streaming as jax_streaming
from blades_tpu_torch.aggregators import AGGREGATORS, UNPORTED, get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.attackers.noise import draw_normals
from blades_tpu_torch.core import ClientOptSpec, RoundEngine, RoundMetrics
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.models import build_fns, cct, create_mnist_model, params_from_jax
from blades_tpu_torch.ops import streaming
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.utils import rng as port_rng

K, D = 7, 33
TOL = dict(rtol=1e-5, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-6)  # GeoMed, AutoGM
ROUND_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)
STREAMING = ("asynccenteredclipping", "asyncmean", "autogm", "centeredclipping",
             "clippedclustering", "clustering", "geomed", "krum", "mean", "median", "multikrum",
             "signguard", "trimmedmean")
OPTOUTS = ("byzantinesgd", "dnc", "fltrust")
# (name, kwargs): every streaming defense, and the variants whose streaming
# form differs (centered clipping's exact n_iter=1, clustering's distance)
CASES = [(n, {"num_byzantine": 2} if n in ("krum", "multikrum", "trimmedmean") else {})
         for n in STREAMING]
CASES += [("centeredclipping", {"n_iter": 1}), ("clustering", {"metric": "distance"}),
          ("multikrum", {"num_byzantine": 1, "num_selected": 3}),
          ("asynccenteredclipping", {"tau": 0.05})]


def _id(case):
    name, kw = case
    return "-".join([name, *(f"{a}{b}" for a, b in kw.items())])


def _tol(name):
    return LOOP_TOL if name in ("geomed", "autogm") else TOL


def _matrix(seed, k=K, d=D):
    return (np.random.RandomState(seed).randn(k, d) * 0.1).astype(np.float32)


def _assert_tree(t, j, tol=TOL):
    """A port state (tensors, dicts, ()) against a JAX state, leaf by leaf."""
    if isinstance(j, dict):
        assert set(t) >= set(j)
        for n in j:
            _assert_tree(t[n], j[n], tol)
        return
    if isinstance(j, tuple) and j == ():
        assert t == ()
        return
    j = np.asarray(j)
    t = t.cpu().numpy()
    assert t.shape == j.shape
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, **tol)
    else:
        np.testing.assert_array_equal(t, j)


# -- the registry ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_streaming_split_matches_jax(name):
    """Each registered defense streams where the JAX package's does, with the
    same ``streaming_exact``, or carries the JAX package's opt-out reason."""
    ours, ref = get_aggregator(name), jax_get_aggregator(name)
    assert ours.supports_streaming() == ref.supports_streaming()
    assert ours.streaming_exact == ref.streaming_exact
    assert ours.streaming_optouts == ref.streaming_optouts
    assert ours.supports_streaming() == (name in STREAMING)


def test_streaming_coverage():
    assert sorted(n for n in AGGREGATORS if get_aggregator(n).supports_streaming()) == sorted(
        STREAMING)
    assert set(AGGREGATORS) - set(STREAMING) == set(OPTOUTS)
    # the JAX registry's streaming defenses are these, and none is unported
    jax_streaming_names = {n for n in JAX_AGGREGATORS
                           if jax_get_aggregator(n).supports_streaming()}
    assert jax_streaming_names == set(STREAMING) and UNPORTED == {}


@pytest.mark.parametrize("name", OPTOUTS)
def test_optouts_raise_with_the_jax_reason(name):
    agg = get_aggregator(name)
    reason = jax_get_aggregator(name).streaming_optouts["streaming"]
    assert agg.streaming_optouts["streaming"] == reason
    with pytest.raises(NotImplementedError) as err:
        agg.streaming_init(K, 2, 4, D)
    assert reason in str(err.value)
    with pytest.raises(NotImplementedError, match="does not implement streaming"):
        agg.aggregate_streaming(torch.zeros(K, D), num_chunks=2)


@pytest.mark.parametrize("name", ["asyncmean", "asynccenteredclipping"])
def test_async_pair_raises_slice_9(name):
    """The async pair is ported (slice 9): it resolves and streams exactly
    where the JAX package's does; with ``n_iter > 1`` asynchronous centered
    clipping opts out with the JAX package's reason."""
    assert get_aggregator(name).supports_streaming() and get_aggregator(name).streaming_exact
    if name == "asynccenteredclipping":
        ours, ref = get_aggregator(name, n_iter=2), jax_get_aggregator(name, n_iter=2)
        assert not ours.supports_streaming() and ours.streaming_exact is False
        assert ours.streaming_optouts == ref.streaming_optouts
        with pytest.raises(NotImplementedError, match="mid-pass"):
            ours.streaming_init(K, 2, 4, D)


# -- ops/streaming.py ----------------------------------------------------------------


@pytest.mark.parametrize("rows,chunks", [(7, 1), (7, 2), (7, 3), (12, 5), (6, 4), (5, 50),
                                         (1000, 4), (4000, 16)])
def test_chunk_layout_matches_jax(rows, chunks):
    assert streaming.chunk_layout(rows, chunks) == jax_streaming.chunk_layout(rows, chunks)


def test_moments_stacks_and_geometry_match_jax():
    x = _matrix(1, 9)
    m = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    t, tm, j, jm = torch.from_numpy(x), torch.from_numpy(m), jnp.asarray(x), jnp.asarray(m)
    tmom = streaming.moments_update(streaming.moments_init(D), t[:4], tm[:4])
    tmom = streaming.moments_update(tmom, t[4:], tm[4:])
    jmom = jax_streaming.moments_update(jax_streaming.moments_init(D), j[:4], jm[:4])
    jmom = jax_streaming.moments_update(jmom, j[4:], jm[4:])
    _assert_tree(tmom, jmom)
    np.testing.assert_allclose(streaming.moments_mean(tmom).numpy(),
                               np.asarray(jax_streaming.moments_mean(jmom)), **TOL)
    np.testing.assert_allclose(streaming.moments_var(tmom).numpy(),
                               np.asarray(jax_streaming.moments_var(jmom)), **TOL)
    np.testing.assert_allclose(streaming.moments_var(tmom).numpy(), x[m].var(0), rtol=1e-4,
                               atol=1e-7)
    counts = np.array([3, 0, 2], np.int32)
    ts = streaming.stack_init(3, (D,))
    js = jax_streaming.stack_init(3, (D,))
    for i in range(3):
        ts = streaming.stack_write(ts, i, t[i])
        js = jax_streaming.stack_write(js, jnp.asarray(i, jnp.int32), j[i])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(
        streaming.weighted_stack_mean(ts, torch.from_numpy(counts)).numpy(),
        np.asarray(jax_streaming.weighted_stack_mean(js, jnp.asarray(counts))), **TOL)
    center = t[tm].mean(0)
    tg = streaming.chunk_geometry(t, tm, center)
    jg = jax_streaming.chunk_geometry(j, jm, jnp.asarray(center.numpy()))
    _assert_tree(tg, jg, dict(rtol=1e-4, atol=1e-5))


# -- aggregate_streaming against the JAX package -----------------------------------


MASKS = {"all": None, "two-off": np.array([1, 0, 1, 1, 1, 1, 0], bool),
         "chunk-empty": np.array([0, 0, 0, 0, 1, 1, 1], bool)}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("chunks", [1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_aggregate_streaming_matches_jax(case, chunks, mask):
    """K=7 rows in 1, 2 (4 + 3, pad 1) or 3 (3 + 3 + 1, pad 2) chunks, all
    participating, two rows out, or the first chunk of 2 empty."""
    name, kw = case
    x = _matrix(10 + chunks)
    m = MASKS[mask]
    ours, ref = get_aggregator(name, **kw), jax_get_aggregator(name, **kw)
    got, tstate = ours.aggregate_streaming(
        torch.from_numpy(x), ours.init_state(K, D), num_chunks=chunks,
        mask=None if m is None else torch.from_numpy(m))
    expect, jstate = ref.aggregate_streaming(
        jnp.asarray(x), ref.init_state(K, D), num_chunks=chunks,
        mask=None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **_tol(name))
    _assert_tree(tstate, jstate, _tol(name))


@pytest.mark.parametrize("garbage", [np.nan, np.inf, 1e30], ids=["nan", "inf", "1e30"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_masked_out_garbage_is_inert(case, garbage):
    """What a masked-out row holds cannot change the streaming result in any
    bit (3 chunks, rows 4-6 out)."""
    name, kw = case
    x = _matrix(20)
    m = torch.from_numpy(np.array([1, 1, 1, 1, 0, 0, 0], bool))
    poisoned = x.copy()
    poisoned[4:] = garbage
    out = []
    for u in (x, poisoned):
        agg = get_aggregator(name, **kw)
        out.append(agg.aggregate_streaming(torch.from_numpy(u), agg.init_state(K, D),
                                           num_chunks=3, mask=m)[0])
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=0)
    assert torch.isfinite(out[1]).all()


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_zero_participants_matches_jax(case):
    name, kw = case
    x = _matrix(21)
    ours, ref = get_aggregator(name, **kw), jax_get_aggregator(name, **kw)
    got, _ = ours.aggregate_streaming(torch.from_numpy(x), ours.init_state(K, D), num_chunks=3,
                                      mask=torch.zeros(K, dtype=torch.bool))
    expect, _ = ref.aggregate_streaming(jnp.asarray(x), ref.init_state(K, D), num_chunks=3,
                                        mask=jnp.zeros(K, bool))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


# -- cross-round state ----------------------------------------------------------------


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("kw", [{}, {"n_iter": 1}, {"tau": 0.2}], ids=["n5", "n1", "tau0.2"])
def test_centeredclipping_momentum_three_rounds_match_jax(kw, chunks):
    ours, ref = get_aggregator("centeredclipping", **kw), jax_get_aggregator(
        "centeredclipping", **kw)
    tstate, jstate = ours.init_state(K, D), ref.init_state(K, D)
    for rnd in range(3):
        x = _matrix(30 + rnd) + 0.05 * rnd
        got, tstate = ours.aggregate_streaming(torch.from_numpy(x), tstate, num_chunks=chunks)
        expect, jstate = ref.aggregate_streaming(jnp.asarray(x), jstate, num_chunks=chunks)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)


def test_centeredclipping_one_chunk_is_the_chunk_momentum():
    """With one chunk the finalize returns that chunk's momentum as it is."""
    agg = get_aggregator("centeredclipping")
    x = torch.from_numpy(_matrix(33))
    got, _ = agg.aggregate_streaming(x, agg.init_state(K, D), num_chunks=1)
    masked, _ = agg.aggregate_masked(x, agg.init_state(K, D), mask=torch.ones(K, dtype=torch.bool))
    torch.testing.assert_close(got, masked, rtol=0, atol=0)


@pytest.mark.parametrize("cap", [65536, 10])
def test_clippedclustering_ring_three_rounds_match_jax(cap):
    """Three rounds of 3 chunks (pad 2), the second with its first chunk
    empty: the ring takes exactly K norms a round (none from the padding,
    none from an empty chunk), and with ``history_cap=10`` it wraps."""
    ours = get_aggregator("clippedclustering", history_cap=cap)
    ref = jax_get_aggregator("clippedclustering", history_cap=cap)
    tstate, jstate = ours.init_state(K, D), ref.init_state(K, D)
    masks = [None, np.array([0, 0, 0, 1, 1, 1, 1], bool), np.array([1, 0, 1, 1, 1, 0, 1], bool)]
    counts = []
    for rnd, m in enumerate(masks):
        x = _matrix(40 + rnd) * (1 + rnd)
        got, tstate = ours.aggregate_streaming(
            torch.from_numpy(x), tstate, num_chunks=3,
            mask=None if m is None else torch.from_numpy(m))
        expect, jstate = ref.aggregate_streaming(
            jnp.asarray(x), jstate, num_chunks=3, mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
        _assert_tree(tstate, jstate)
        counts.append(int(tstate["count"]))
    # round 2's empty first chunk writes nothing: 3 + 1 rows of chunks 2-3
    assert counts == ([7, 11, 18] if cap > 100 else [7, 10, 10])


# -- the fault model's streaming pass ---------------------------------------------------


PLAN_CASES = {
    "dropout": dict(dropout_rate=0.4),
    "schedule": dict(participation_schedule=np.array([[1, 0, 1, 1, 0, 1, 1],
                                                      [0, 1, 1, 1, 1, 1, 0]], bool)),
    "corrupt-rate": dict(dropout_rate=0.3, corrupt_rate=0.5),
    "corrupt-clients": dict(dropout_rate=0.3, corrupt_clients=(0, 3, 9)),
    "inf": dict(corrupt_rate=0.5, corrupt_mode="inf"),
    "bitflip": dict(dropout_rate=0.2, corrupt_rate=0.5, corrupt_mode="bitflip"),
    "none": dict(),
}


def _queue_bernoulli(monkeypatch, draws):
    queue = [d.numpy() for d in draws]

    def bernoulli(key, p=0.5, shape=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return queue


@pytest.mark.parametrize("rnd", [0, 1])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_streaming_and_corrupt_chunk_match_jax(monkeypatch, case, rnd):
    """``plan_streaming`` and ``corrupt_chunk`` on both sides, the port's
    draws handed to JAX: the masks and every chunk bit for bit; and the
    plan's counts equal the port's dense ``apply`` on the same generator."""
    kw = PLAN_CASES[case]
    fm, jfm = FaultModel(**kw), JaxFaultModel(**kw)
    gen = port_rng.generator(5, rnd, port_rng.FAULT)
    part, drop, corrupt = fm.plan_streaming(K, gen, rnd)
    plan_draws = draw_faults(fm, K, None, port_rng.generator(5, rnd, port_rng.FAULT))
    queue = _queue_bernoulli(monkeypatch, [d for d in plan_draws.values() if d is not None])
    jpart, jdrop, jcorrupt, _ = jfm.plan_streaming(K, jax.random.key(0), rnd)
    assert queue == []
    for a, b in ((part, jpart), (drop, jdrop), (corrupt, jcorrupt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not (corrupt & ~part).any()
    # the dense pass on the same generator draws the same [K] decisions
    x = torch.from_numpy(_matrix(50))
    _, dmask, _, diag = fm.apply(x, fm.init_state(K, D),
                                 port_rng.generator(5, rnd, port_rng.FAULT), rnd)
    assert int(diag["dropped"]) == int(drop.sum())
    assert int(diag["corrupted"]) == int(corrupt.sum())
    # each chunk corrupted on both sides
    fill = fm.init_state(K, D)
    fill = fill["fill"] if isinstance(fill, dict) else None
    for j, rows in enumerate((slice(0, 4), slice(4, 7))):
        slab = x[rows] * (1 + j)
        cgen = port_rng.generator(5, rnd, port_rng.FAULT, chunk=j)
        got = fm.corrupt_chunk(slab, corrupt[rows], cgen, fill=fill)
        flips = []
        if fm.corrupt_mode == "bitflip":
            flips = [torch.empty(tuple(slab.shape), dtype=torch.bool).bernoulli_(
                fm.bitflip_frac, generator=port_rng.generator(5, rnd, port_rng.FAULT, chunk=j))]
        queue = _queue_bernoulli(monkeypatch, flips)
        expect = jfm.corrupt_chunk(jnp.asarray(slab.numpy()), jnp.asarray(corrupt[rows].numpy()),
                                   jax.random.key(0),
                                   fill=None if fill is None else jnp.asarray(fill.numpy()))
        assert queue == []
        np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_plan_streaming_rejects_stragglers():
    with pytest.raises(ValueError, match="straggler"):
        FaultModel(straggler_rate=0.2).plan_streaming(K, port_rng.generator(0, 0, 7), 0)


def test_chunk_generators_are_distinct_and_seeded():
    a = port_rng.generator(1, 2, port_rng.ATTACK, chunk=0)
    b = port_rng.generator(1, 2, port_rng.ATTACK, chunk=1)
    c = port_rng.generator(1, 2, port_rng.ATTACK)
    draws = [torch.rand(4, generator=g) for g in (a, b, c)]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    again = torch.rand(4, generator=port_rng.generator(1, 2, port_rng.ATTACK, chunk=0))
    assert torch.equal(draws[0], again)


# -- the engine --------------------------------------------------------------------------


S, B = 2, 8
CLIENT_LR, SERVER_LR = 0.1, 1.0
F = 2


def _batches(rnd, k=K):
    rng = np.random.RandomState(300 + rnd)
    cx = rng.randn(k, S, B, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (k, S, B)).astype(np.int32)
    return cx, cy


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _port_engine(params=None, aggregator=("trimmedmean", {"num_byzantine": 2}),
                 attack=("signflipping", {}), faults=None, chunks=2, streaming_on=True,
                 **kw):
    spec = create_mnist_model()
    if params is None:
        params = spec.init(torch.Generator().manual_seed(0))
    return RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout, num_clients=K,
        num_byzantine=F, attack=get_attack(attack[0], **attack[1]),
        aggregator=get_aggregator(aggregator[0], **aggregator[1]), client_chunks=chunks,
        device="cpu", fault_model=None if faults is None else FaultModel(**faults),
        streaming=streaming_on, **kw,
    ), params


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


def _stream_engines(jax_params, aggregator, attack, faults, chunks=2, client_opt=None):
    jspec, tspec = jax_mlp(), create_mnist_model()
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jax_params, num_clients=K,
        num_byzantine=F, attack=jax_get_attack(attack[0], **attack[1]),
        aggregator=jax_get_aggregator(aggregator[0], **aggregator[1]), plan=None,
        client_chunks=chunks, streaming=True,
        fault_model=None if faults is None else JaxFaultModel(**faults),
        client_opt=JaxClientOptSpec(**(client_opt or {})),
    )
    tparams = params_from_jax(jax_params, tspec.layout)
    teng, _ = _port_engine(tparams, aggregator, attack, faults, chunks,
                           client_opt=ClientOptSpec(**(client_opt or {})))
    return (jeng, jeng.init(jax_params)), (teng, teng.init(tparams), tspec.layout)


def _chunk_draws(teng, seed, rnd):
    """The port's per-chunk draws of round ``rnd``: the noise attack's
    normals and the bit-flip patterns, in the order JAX's eager chunk scan
    asks for them; and the fault plan's [K] draws."""
    normals, flips = [], []
    shape = (teng.chunk_size, teng.dim)
    for j in range(teng.client_chunks):
        if type(teng.attack).__name__ == "Noise":
            normals.append(draw_normals(
                shape, port_rng.generator(seed, rnd, port_rng.ATTACK, chunk=j), "cpu"))
        if teng.fault_model is not None and teng.fault_model.corrupt_mode == "bitflip":
            flips.append(torch.empty(shape, dtype=torch.bool).bernoulli_(
                teng.fault_model.bitflip_frac,
                generator=port_rng.generator(seed, rnd, port_rng.FAULT, chunk=j)))
    plan = []
    if teng.fault_model is not None:
        plan = [d for d in draw_faults(teng.fault_model, K, None, port_rng.generator(
            seed, rnd, port_rng.FAULT)).values() if d is not None]
    return normals, plan + flips


def _run_both(monkeypatch, j, t, rnd, seed=0, steps=None):
    (jeng, jstate), (teng, tstate, layout) = j, t
    normals, bern = _chunk_draws(teng, seed, rnd)
    nq = [a.numpy() for a in normals]
    bq = _queue_bernoulli(monkeypatch, bern)
    monkeypatch.setattr(jax.random, "normal", lambda *a, **kw: jnp.asarray(nq.pop(0)))
    cx, cy = (a[:, :steps] for a in _batches(rnd))
    eager = bool(normals) or any(b.dim() == 2 for b in bern)
    with jax.disable_jit(eager):
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy), CLIENT_LR,
                                SERVER_LR, seed=seed)
    assert nq == [] and bq == []  # JAX took every draw, in order
    return (jeng, jstate), (teng, tstate, layout), jm, tm


def _check_round(j, t, jm, tm, tol=ROUND_TOL):
    (jeng, jstate), (teng, tstate, layout) = j, t
    np.testing.assert_allclose(ravel(tstate.params, layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **tol)
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else tol["atol"]
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=tol["rtol"], atol=atol, err_msg=name)
    if jeng.fault_model is not None:
        assert {n: int(v) for n, v in teng.last_fault_diag.items()} == {
            n: int(v) for n, v in jeng.last_fault_diag.items()}
    else:
        assert teng.last_fault_diag is None
    assert teng.last_updates is None
    _assert_tree(tstate.agg_state, jstate.agg_state, tol)


FAULT_CASES = {
    "none": None,
    "nan": dict(dropout_rate=0.3, corrupt_clients=(1, 4)),
    # the default 2^15 bit-flip scale would multiply the two frameworks'
    # rounding differences in a flipped survivor past ROUND_TOL; the draws
    # and masks are what this holds, and test_plan_streaming_... holds the
    # default scale bit for bit
    "bitflip": dict(dropout_rate=0.2, corrupt_rate=0.4, corrupt_mode="bitflip",
                    bitflip_scale=2.0),
}
ATTACKS = [("signflipping", {}), ("labelflipping", {"num_classes": 10}), ("noise", {})]


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


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mlp_streaming_round_per_defense_matches_jax(jax_params, monkeypatch, case):
    """One K=7 MLP streaming round of 2 chunks (pad 1) with each streaming
    defense under sign flipping and 30% dropout, against JAX; stateful
    defenses' state too."""
    faults = dict(dropout_rate=0.3)
    j, t = _stream_engines(jax_params, case, ("signflipping", {}), faults)
    j, t, jm, tm = _run_both(monkeypatch, j, t, 0, seed=4)
    _check_round(j, t, jm, tm)


def test_mlp_streaming_round_with_no_participant_applies_zero():
    sched = np.zeros((1, K), bool)
    eng, params = _port_engine(faults=dict(participation_schedule=sched), chunks=3)
    state = eng.init(params)
    cx, cy = (torch.from_numpy(a) for a in _batches(0))
    new, m = eng.run_round(state, cx, cy, CLIENT_LR, SERVER_LR)
    assert float(m.agg_norm) == 0.0 and int(eng.last_fault_diag["participants"]) == 0
    for n in params:
        torch.testing.assert_close(new.params[n], state.params[n], rtol=0, atol=0)


# -- the exact forms against the port's dense round --------------------------------------


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


# -- CCT-2 ----------------------------------------------------------------------------


CCT_K, CCT_F, CCT_B = 6, 2, 4
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)


def test_cct2_streaming_round_matches_jax():
    """One K=6 CCT-2 streaming round (D = 283,723) in 4 requested chunks (3
    of 2), sign flipping f=2 and trimmed mean b=2, dropout and stochastic
    depth at 0 on both sides, against the JAX streaming engine."""
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), (32, 32, 3))
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tspec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=CCT_K,
        num_byzantine=CCT_F, attack=jax_get_attack("signflipping"),
        aggregator=jax_get_aggregator("trimmedmean", num_byzantine=2), plan=None,
        client_chunks=4, streaming=True,
    )
    tparams = params_from_jax(jparams, tspec.layout)
    teng = RoundEngine(
        tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout,
        num_clients=CCT_K, num_byzantine=CCT_F, attack=get_attack("signflipping"),
        aggregator=get_aggregator("trimmedmean", num_byzantine=2), client_chunks=4,
        device="cpu", noise_sites=tspec.noise_sites, streaming=True,
    )
    assert (teng.client_chunks, teng.chunk_size) == (jeng.client_chunks, jeng.chunk_size)
    rng = np.random.RandomState(203)
    cx = rng.randn(CCT_K, 1, CCT_B, 32, 32, 3).astype(np.float32)
    cy = rng.randint(0, 10, (CCT_K, 1, CCT_B)).astype(np.int32)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx),
                                torch.from_numpy(cy), CLIENT_LR, SERVER_LR)
    np.testing.assert_allclose(ravel(tstate.params, tspec.layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **ROUND_TOL)
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else ROUND_TOL["atol"]
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=ROUND_TOL["rtol"], atol=atol, err_msg=name)


def test_cct2_streaming_mean_round_equals_dense_with_dropout():
    """CCT-2 at its default dropout and DropPath rates, K=6 in 3 chunks:
    the streaming round draws the dense round's masks, so the mean's
    streaming round equals the dense one."""
    spec = build_fns(cct.cct_2_3x2_32())
    assert spec.noise_sites(CCT_B)
    params = spec.init(torch.Generator().manual_seed(4))
    rng = np.random.RandomState(204)
    cx = torch.from_numpy(rng.randn(CCT_K, 1, CCT_B, 32, 32, 3).astype(np.float32))
    cy = torch.from_numpy(rng.randint(0, 10, (CCT_K, 1, CCT_B)).astype(np.int64))
    out = []
    for on in (True, False):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=CCT_K, aggregator=get_aggregator("mean"),
                          client_chunks=3, device="cpu", noise_sites=spec.noise_sites,
                          streaming=on)
        state, m = eng.run_round(eng.init(params), cx, cy, CLIENT_LR, SERVER_LR, seed=3)
        out.append((ravel(state.params, spec.layout), float(m.train_loss)))
    torch.testing.assert_close(out[0][0], out[1][0], **EXACT_TOL)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-6)


# -- persistent client state ---------------------------------------------------------


@pytest.mark.parametrize("client_opt", [
    dict(name="sgd", momentum=0.9, weight_decay=1e-2, persist=True),
    dict(name="adam", persist=True),
], ids=["momentum", "adam"])
def test_persistent_client_state_streaming_rounds_match_jax(jax_params, monkeypatch,
                                                            client_opt):
    """K=7 MLP streaming rounds of 2 chunks (4 + 3, pad 1) with
    ``persist=True``, sign flipping and trimmed mean b=2 under 30% dropout
    (momentum two rounds of 2 local steps; Adam one round of one step: its
    first step ``g / (|g| + eps)`` turns a near-zero gradient's rounding
    into a step of order lr that every later gradient feels):
    each chunk trains from its rows of the stacked client state, and the
    new rows come back, against the JAX streaming round: the params and
    metrics, and every client's state (momentum's trace at ``ROUND_TOL``;
    Adam's count exactly, its moments and its params at the multi-round
    ``rtol=1e-3, atol=1e-5``, the params where every client's
    ``sqrt(nu_hat)`` exceeds 1e-6, as in ``tests/test_torch_engine.py``)."""
    adam_tol = dict(rtol=1e-3, atol=1e-5)
    faults = dict(dropout_rate=0.3)
    j, t = _stream_engines(jax_params, ("trimmedmean", {"num_byzantine": 2}),
                           ("signflipping", {}), faults, client_opt=client_opt)
    rows = jax.vmap(lambda x: ravel_pytree(x)[0])
    sgd = client_opt["name"] == "sgd"
    for rnd in range(2 if sgd else 1):
        j = (_stream_engines(jax_params, ("trimmedmean", {"num_byzantine": 2}),
                             ("signflipping", {}), faults, client_opt=client_opt)[0][0], j[1])
        j, t, jm, tm = _run_both(monkeypatch, j, t, rnd, seed=6, steps=None if sgd else 1)
        tpart, jpart = t[1].client_opt_state[-1], j[1].client_opt_state[-1]
        if client_opt["name"] == "sgd":
            _check_round(j, t, jm, tm)
            np.testing.assert_allclose(t[0]._ravel_rows(tpart).numpy(),
                                       np.asarray(rows(jpart.trace)), **ROUND_TOL)
            continue
        count, mu, nu = tpart
        np.testing.assert_array_equal(count.numpy(), np.asarray(jpart.count))
        assert count.tolist() == [1] * K
        np.testing.assert_allclose(t[0]._ravel_rows(mu).numpy(), np.asarray(rows(jpart.mu)),
                                   **adam_tol)
        np.testing.assert_allclose(t[0]._ravel_rows(nu).numpy(), np.asarray(rows(jpart.nu)),
                                   **adam_tol)
        nu_hat = np.asarray(rows(jpart.nu)) / (1 - 0.999 ** np.asarray(jpart.count)[:, None])
        ok = np.sqrt(nu_hat).min(axis=0) > 1e-6
        np.testing.assert_allclose(ravel(t[1].params, t[2]).numpy()[ok],
                                   np.asarray(ravel_pytree(j[1].params)[0])[ok], **adam_tol)
        assert ok.sum() > 0.5 * ok.size
