"""The port's streaming forms against the JAX package's (the registry and
the streaming reductions; the streaming rounds are in
``tests/test_torch_streaming_rounds.py`` and
``tests/test_torch_streaming_models.py``, the shared helpers in
``tests/torch_streaming_helpers.py``).

Covered: the registry's split (13 streaming defenses with the async pair,
3 opt-outs with the JAX package's reasons, and asynchronous centered
clipping's with ``n_iter > 1``); every streaming
defense's ``aggregate_streaming`` at 1, 2 and 3 chunks of K=7 rows (2 and
3 chunks pad the final chunk), with and without a mask, against JAX's;
masked-out garbage and zero participants; three rounds of centered
clipping's momentum and clipped clustering's ring; ``plan_streaming`` and
``corrupt_chunk`` (the streaming fault plan's ``[K]`` draws are the port's
``draw_faults`` with ``dim=None``); the per-chunk generators.

Tolerances: ``aggregate_streaming`` f32 ``rtol=atol=1e-5``, GeoMed and
AutoGM ``rtol=1e-4, atol=1e-6``. Streaming is compared with streaming:
the JAX package's own two-level trimmed mean drifts from its dense one
(``ROADMAP.md`` queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.aggregators import AGGREGATORS as JAX_AGGREGATORS
from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.ops import streaming as jax_streaming
from blades_tpu_torch.aggregators import AGGREGATORS, UNPORTED, get_aggregator
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.ops import streaming
from blades_tpu_torch.utils import rng as port_rng

from torch_streaming_helpers import (
    CASES,
    D,
    K,
    MASKS,
    OPTOUTS,
    PLAN_CASES,
    STREAMING,
    TOL,
    _assert_tree,
    _id,
    _matrix,
    _queue_bernoulli,
    _tol,
)


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
