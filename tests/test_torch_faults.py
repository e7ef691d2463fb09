"""The port's partial-participation path against the JAX package: the masked
reductions, every registered aggregator's masked form, ByzantineSGD and
SignGuard, the gossip aggregators and the fault model.

Inputs are seeded numpy ``[K=12, D=64]`` matrices, plain or with ALIE-style
identical rows (the first four), and a mask that drops 4 rows (one of them
an ALIE row). Tolerances are those of ``tests/test_torch_aggregators.py``:
f32 ``rtol=atol=1e-5`` (the two frameworks sum in other orders; the port's
masked trimmed mean also sums its survivors in sorted order where the JAX
package sums them in row order); GeoMed and AutoGM ``rtol=1e-4,
atol=1e-6``. The content of a masked-out row must not change the result at
all, and the fault model's outputs (where-copies, sign flips, powers of two)
must be bit-identical. The fault model's random draws and DnC's are the
port's, handed to the JAX package by patching ``jax.random.bernoulli`` (and
``choice`` / ``normal``) in call order; JAX's DnC loop runs under
``jax.disable_jit`` so each iteration takes its own draw. Cross-round state
(the straggler buffer, ByzantineSGD's, clipped clustering's, centered
clipping's) is compared after every round, and carried from the JAX package
into the port with ``models.state_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.aggregators import AGGREGATORS as JAX_AGGREGATORS
from blades_tpu.aggregators import decentralized as jax_decentralized
from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.ops import masked as jax_masked
from blades_tpu_torch.aggregators import AGGREGATORS, UNPORTED, Aggregator, get_aggregator
from blades_tpu_torch.aggregators import decentralized
from blades_tpu_torch.aggregators.dnc import draw_subspaces
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.models import state_from_jax
from blades_tpu_torch.ops import masked

K, D = 12, 64
TOL = dict(rtol=1e-5, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-6)  # GeoMed, AutoGM
DROPPED = (2, 5, 7, 10)  # row 2 is an ALIE row
TRUSTED = K - 1
NAMES = sorted(AGGREGATORS)


def _matrix(kind="plain", seed=0, k=K, d=D):
    rng = np.random.RandomState(seed + 31 * k)
    x = (rng.randn(k, d) * 0.1).astype(np.float32)
    if kind == "alie":
        x[:4] = x[0]
    return x


def _mask(dropped=DROPPED, k=K):
    m = np.ones(k, bool)
    m[list(dropped)] = False
    return m


def _tol(name):
    return LOOP_TOL if name in ("geomed", "autogm") else TOL


def _kwargs(name):
    return {"num_byzantine": 2} if name in ("trimmedmean", "krum", "multikrum", "dnc") else {}


def _assert_state(tstate, jstate, tol=TOL):
    """The port's state against the JAX package's, leaf by leaf."""
    if isinstance(jstate, dict):
        assert set(tstate) == set(jstate)
        for n in jstate:
            _assert_state(tstate[n], jstate[n], tol)
        return
    if isinstance(jstate, tuple) and jstate == ():
        assert tstate == ()
        return
    expect = np.asarray(jstate)
    got = tstate.cpu().numpy()
    assert got.shape == expect.shape
    if expect.dtype.kind == "f":
        np.testing.assert_allclose(got, expect, **tol)
    else:
        np.testing.assert_array_equal(got, expect)


class _Both:
    """One aggregator in each package, with its context: the trusted client
    for FLTrust, the flat params for ByzantineSGD, and for DnC the port's
    draws (from a generator seeded ``seed``) queued for the JAX package."""

    def __init__(self, name, kw, monkeypatch, seed=5):
        self.name = name
        self.ours = get_aggregator(name, **kw)
        self.ref = jax_get_aggregator(name, **kw)
        self.seed = seed
        self.monkeypatch = monkeypatch

    def ctx(self, rnd=0, d=D, k=K):
        tctx, jctx = {}, {}
        if self.name == "fltrust":
            trusted = np.arange(k) == TRUSTED
            tctx["trusted_mask"] = torch.from_numpy(trusted)
            jctx["trusted_mask"] = jnp.asarray(trusted)
        if self.name == "byzantinesgd":
            p = np.random.RandomState(40 + rnd).randn(d).astype(np.float32) * (1 + rnd)
            tctx["params_flat"], jctx["params_flat"] = torch.from_numpy(p), jnp.asarray(p)
        if self.name == "dnc":
            tctx["generator"] = torch.Generator().manual_seed(self.seed + rnd)
            jctx["key"] = jax.random.key(0)
        return tctx, jctx

    def run(self, x, mask, tstate, jstate, rnd=0):
        """``(port result, port state, JAX result, JAX state)`` of
        ``aggregate_masked`` (``mask=None``: ``aggregate``)."""
        k, d = x.shape
        tctx, jctx = self.ctx(rnd, d, k)
        tmask = None if mask is None else torch.from_numpy(mask)
        jmask = None if mask is None else jnp.asarray(mask)
        got, tstate = self.ours.aggregate_masked(torch.from_numpy(x), tstate, mask=tmask, **tctx)
        if self.name != "dnc":
            expect, jstate = self.ref.aggregate_masked(jnp.asarray(x), jstate, mask=jmask, **jctx)
            return got, tstate, np.asarray(expect), jstate
        agg = self.ours
        draws = draw_subspaces(torch.Generator().manual_seed(self.seed + rnd), agg.num_iters, d,
                               min(agg.sub_dim, d), "cpu")
        queue = [t.numpy() for pair in draws for t in pair]

        def take(key, *args, **kwargs):
            arr = queue.pop(0)
            return jnp.asarray(arr.astype(np.int32) if arr.dtype == np.int64 else arr)

        self.monkeypatch.setattr(jax.random, "choice", take)
        self.monkeypatch.setattr(jax.random, "normal", take)
        with jax.disable_jit():
            expect, jstate = self.ref.aggregate_masked(jnp.asarray(x), jstate, mask=jmask, **jctx)
        assert queue == []  # the JAX side took every draw, in order
        return got, tstate, np.asarray(expect), jstate


# -- the registry ----------------------------------------------------------------


def test_registry_matches_jax_but_async():
    """The whole JAX registry, the async pair included since slice 9."""
    assert set(AGGREGATORS) == set(JAX_AGGREGATORS)
    assert UNPORTED == {}
    for name in ("asyncmean", "asynccenteredclipping"):
        assert get_aggregator(name)._masked_aggregate is not Aggregator._masked_aggregate


@pytest.mark.parametrize("name", NAMES)
def test_registered_aggregator_has_masked_form(name):
    assert AGGREGATORS[name]._masked_aggregate is not Aggregator._masked_aggregate


def test_base_masked_aggregate_raises():
    class Bare(Aggregator):
        def aggregate(self, updates, state=(), **ctx):
            return updates.mean(dim=0), state

    with pytest.raises(NotImplementedError, match="mask-aware"):
        Bare().aggregate_masked(torch.zeros(4, 3), mask=torch.ones(4, dtype=torch.bool))


# -- every masked form against the JAX package's ---------------------------------

CASES = [
    ("mean", {}), ("median", {}),
    ("trimmedmean", {"num_byzantine": 2}),
    ("trimmedmean", {"num_byzantine": 5}),  # b_eff clamps to (8 - 1) // 2 = 3
    ("krum", {"num_byzantine": 2}),
    ("krum", {"num_byzantine": 2, "distance_power": 4}),
    ("multikrum", {"num_byzantine": 2, "num_selected": 3}),
    ("geomed", {}), ("autogm", {}),
    ("centeredclipping", {}), ("centeredclipping", {"tau": 0.5, "n_iter": 3}),
    ("clustering", {"metric": "similarity"}), ("clustering", {"metric": "distance"}),
    ("clippedclustering", {}), ("clippedclustering", {"tau": 0.5}),
    ("fltrust", {}),
    ("byzantinesgd", {}), ("byzantinesgd", {"th_A": 0.05, "th_B": 0.8, "th_V": 0.25}),
    ("dnc", {"num_byzantine": 2, "sub_dim": 16, "num_iters": 3}),
    ("signguard", {}), ("signguard", {"lower": 0.9, "upper": 1.1}),
    ("asyncmean", {}), ("asynccenteredclipping", {}),
    ("asynccenteredclipping", {"tau": 0.05, "n_iter": 3}),
]


def _case_id(case):
    name, kw = case
    return "-".join([name, *(f"{a}{b}" for a, b in kw.items())])


@pytest.mark.parametrize("kind", ["plain", "alie"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_masked_aggregate_matches_jax(monkeypatch, case, kind):
    name, kw = case
    both = _Both(name, kw, monkeypatch)
    x = _matrix(kind, seed=1)
    got, tstate, expect, jstate = both.run(
        x, _mask(), both.ours.init_state(K, D), both.ref.init_state(K, D))
    assert got.shape == (D,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), expect, **_tol(name))
    _assert_state(tstate, jstate)


@pytest.mark.parametrize("case", [
    ("centeredclipping", {"tau": 0.5, "n_iter": 3}),
    ("asynccenteredclipping", {"tau": 0.05, "n_iter": 2}),
    ("clippedclustering", {"history_cap": 30}),  # the ring wraps in round 3
    ("byzantinesgd", {}),
    ("byzantinesgd", {"th_A": 0.05, "th_B": 0.8, "th_V": 0.25}),
], ids=_case_id)
def test_stateful_masked_three_rounds_match_jax(monkeypatch, case):
    """Three rounds under a changing mask (4 dropped, none, 6 dropped), the
    updates growing each round; the port starts from the JAX package's
    initial state carried over, and the states agree after every round."""
    name, kw = case
    both = _Both(name, kw, monkeypatch)
    jstate = both.ref.init_state(K, D)
    tstate = state_from_jax(jstate)
    _assert_state(both.ours.init_state(K, D), jstate)
    for rnd, dropped in enumerate((DROPPED, (), (0, 1, 4, 6, 8, 9))):
        x = _matrix("alie", seed=rnd) * (1.0 + rnd)
        got, tstate, expect, jstate = both.run(x, _mask(dropped), tstate, jstate, rnd)
        np.testing.assert_allclose(got.numpy(), expect, **TOL)
        _assert_state(tstate, jstate)
    if name == "byzantinesgd" and kw:
        assert not tstate["good"].all()  # the filters removed someone


# -- the three mask contracts -----------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_mask_none_is_the_unmasked_path(monkeypatch, name):
    both = _Both(name, _kwargs(name), monkeypatch)
    x = torch.from_numpy(_matrix("plain", seed=2))
    tctx, _ = both.ctx()
    a, sa = both.ours.aggregate_masked(x, both.ours.init_state(K, D), mask=None, **tctx)
    tctx, _ = both.ctx()  # a fresh generator for DnC
    b, sb = both.ours.aggregate(x, both.ours.init_state(K, D), **tctx)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_all_ones_mask_agrees_with_aggregate(monkeypatch, name):
    """To tolerance, not bitwise: the dense trimmed mean is the kernel's
    plain version, the masked one a sentinel sort, and the JAX package's own
    bit-identity fails for the mean family on this jaxlib (ROADMAP queue C)."""
    both = _Both(name, _kwargs(name), monkeypatch)
    x = torch.from_numpy(_matrix("plain", seed=3))
    tctx, _ = both.ctx()
    dense, _ = both.ours.aggregate(x, both.ours.init_state(K, D), **tctx)
    tctx, _ = both.ctx()
    got, _ = both.ours.aggregate_masked(x, both.ours.init_state(K, D),
                                        mask=torch.ones(K, dtype=torch.bool), **tctx)
    torch.testing.assert_close(got, dense, **_tol(name))


@pytest.mark.parametrize("garbage", [np.nan, np.inf, 1e30], ids=["nan", "inf", "1e30"])
@pytest.mark.parametrize("name", NAMES)
def test_masked_out_row_cannot_change_result(monkeypatch, name, garbage):
    both = _Both(name, _kwargs(name), monkeypatch)
    base = _matrix("plain", seed=4)
    poisoned = base.copy()
    poisoned[list(DROPPED)] = garbage
    mask = torch.from_numpy(_mask())
    out = []
    for x in (base, poisoned):
        tctx, _ = both.ctx()
        agg = get_aggregator(name, **_kwargs(name))
        out.append(agg.aggregate_masked(torch.from_numpy(x), agg.init_state(K, D), mask=mask,
                                        **tctx)[0])
    assert torch.equal(out[0], out[1])
    assert bool(torch.isfinite(out[1]).all())


@pytest.mark.parametrize("name", NAMES)
def test_zero_participants_matches_jax(monkeypatch, name):
    """No participant: a finite vector, the JAX package's (the engine then
    applies the zero update either way)."""
    both = _Both(name, _kwargs(name), monkeypatch)
    x = _matrix("plain", seed=5)
    got, _, expect, _ = both.run(x, np.zeros(K, bool), both.ours.init_state(K, D),
                                 both.ref.init_state(K, D))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), expect, **_tol(name))


# -- masked reductions: the JAX package and closed forms ----------------------------


@pytest.mark.parametrize("dropped", [DROPPED, (), tuple(range(1, K)), tuple(range(K))],
                         ids=["drop4", "none", "one-left", "all"])
@pytest.mark.parametrize("kind", ["plain", "alie"])
def test_masked_ops_match_jax(kind, dropped):
    x = _matrix(kind, seed=6)
    x[0, :5] = 0.0
    x[1, :5] = -0.0  # -0.0 and 0.0 tie
    m = _mask(dropped)
    t, tm = torch.from_numpy(x), torch.from_numpy(m)
    j, jm = jnp.asarray(x), jnp.asarray(m)
    assert int(masked.participant_count(tm)) == int(jax_masked.participant_count(jm))
    assert masked.participant_count(tm).dtype == torch.int32
    for ours, ref in ((masked.masked_mean, jax_masked.masked_mean),
                      (masked.masked_median, jax_masked.masked_median)):
        np.testing.assert_allclose(ours(t, tm).numpy(), np.asarray(ref(j, jm)), **TOL)
    for b in (0, 1, 2, 5):
        np.testing.assert_allclose(masked.masked_trimmed_mean(t, tm, b).numpy(),
                                   np.asarray(jax_masked.masked_trimmed_mean(j, jm, b)), **TOL)
    np.testing.assert_allclose(float(masked.masked_median_1d(t[:, 3], tm)),
                               float(jax_masked.masked_median_1d(j[:, 3], jm)), **TOL)


def test_masked_mean_median_trimmed_closed_forms():
    x = _matrix("plain", seed=7)
    m = np.array([True, False, True, True, False, True, True, True, False, True, True, False])
    sub = x[m]
    t, tm = torch.from_numpy(x), torch.from_numpy(m)
    np.testing.assert_allclose(masked.masked_mean(t, tm).numpy(), sub.mean(0), rtol=1e-6)
    np.testing.assert_allclose(masked.masked_median(t, tm).numpy(), np.median(sub, axis=0),
                               rtol=1e-6)
    b = 2
    expected = np.mean(np.sort(sub, axis=0)[b:len(sub) - b], axis=0)
    np.testing.assert_allclose(masked.masked_trimmed_mean(t, tm, b).numpy(), expected, rtol=1e-5)


def test_masked_trimmed_mean_b_clamps_under_heavy_dropout():
    # 3 participants with b=2 would trim everyone; b_eff=1 keeps the median
    x = _matrix("plain", seed=8)
    m = torch.from_numpy(_mask(range(3, K)))
    np.testing.assert_allclose(masked.masked_trimmed_mean(torch.from_numpy(x), m, 2).numpy(),
                               np.median(x[:3], axis=0), rtol=1e-5)


# -- the masked trimmed mean with non-finite participants ----------------------
#
# NaN sorts past the +inf sentinels of masked-out rows, so with more NaN
# participants than b_eff a sentinel's slot is kept: the JAX package then adds
# that row's sanitized 0 (it sums the real rows at the kept ranks), and the
# port must too. +inf participants tie with the sentinels and the tie breaks
# by row index, as JAX's stable argsort breaks it.


def _c1_case(fill, n_bad, off=(6,), k=10, d=5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(k, d).astype(np.float32)
    m = np.ones(k, bool)
    m[list(off)] = False
    x[:n_bad] = fill
    return np.where(m[:, None], x, 0.0).astype(np.float32), m


@pytest.mark.parametrize("n_bad", [1, 2, 3, 4])
@pytest.mark.parametrize("fill", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
def test_masked_trimmed_mean_nonfinite_participants_match_jax(fill, n_bad):
    """K=10, row 6 masked out, b=2 and 1-4 NaN, +Inf or -Inf participants,
    through ``Trimmedmean.aggregate_masked`` and the op itself: the port's
    result equals the JAX package's, NaN for NaN and Inf for Inf."""
    x, m = _c1_case(fill, n_bad)
    got = masked.masked_trimmed_mean(torch.from_numpy(x), torch.from_numpy(m), 2).numpy()
    expect = np.asarray(jax_masked.masked_trimmed_mean(jnp.asarray(x), jnp.asarray(m), 2))
    np.testing.assert_allclose(got, expect, equal_nan=True, **TOL)
    agg, _ = get_aggregator("trimmedmean", num_byzantine=2).aggregate_masked(
        torch.from_numpy(x), (), mask=torch.from_numpy(m))
    ref, _ = jax_get_aggregator("trimmedmean", num_byzantine=2).aggregate_masked(
        jnp.asarray(x), (), mask=jnp.asarray(m))
    np.testing.assert_allclose(agg.numpy(), np.asarray(ref), equal_nan=True, **TOL)
    if fill != fill and n_bad == 3:
        # the case the sorted-value sum got wrong: three NaN participants
        # past b_eff = 2 leave the masked-out row's 0 in a kept slot
        assert np.isfinite(got).all()


@pytest.mark.parametrize("seed", range(6))
def test_masked_trimmed_mean_random_nonfinite_cases_match_jax(seed):
    """50 seeded cases a seed: K from 3 to 13, rounded values (ties), NaN,
    +Inf and -Inf participants, masked-out rows sanitized to 0, b from 0 to
    3 (shrunk as the aggregator shrinks it)."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        k = int(rng.integers(3, 14))
        x = rng.normal(size=(k, 6)).astype(np.float32)
        if rng.random() < 0.5:
            x = np.round(x)
        m = rng.random(k) < 0.7
        for i, r in enumerate(rng.random(k)):
            if r < 0.15:
                x[i] = np.nan
            elif r < 0.25:
                x[i] = np.inf
            elif r < 0.3:
                x[i] = -np.inf
        x = np.where(m[:, None], x, 0.0).astype(np.float32)
        b = min(int(rng.integers(0, 4)), (k - 1) // 2)
        got = masked.masked_trimmed_mean(torch.from_numpy(x), torch.from_numpy(m), b).numpy()
        expect = np.asarray(jax_masked.masked_trimmed_mean(jnp.asarray(x), jnp.asarray(m), b))
        np.testing.assert_allclose(got, expect, equal_nan=True, err_msg=f"k={k} b={b}", **TOL)


def test_masked_krum_selects_among_participants_only():
    rng = np.random.default_rng(7)
    benign = rng.normal(size=(6, 4)).astype(np.float32) * 0.1
    x = np.vstack([np.full((3, 4), 50.0, np.float32), benign])
    mask = torch.tensor([True, True, True, False, True, True, True, True, True])
    out, _ = get_aggregator("krum", num_byzantine=2).aggregate_masked(torch.from_numpy(x),
                                                                       mask=mask)
    assert np.linalg.norm(benign[1:] - out.numpy(), axis=1).min() < 1e-5


def test_masked_krum_single_participant_returns_its_update():
    x = _matrix("plain", seed=9)
    mask = torch.from_numpy(np.arange(K) == 4)
    out, _ = get_aggregator("krum", num_byzantine=2).aggregate_masked(torch.from_numpy(x),
                                                                       mask=mask)
    np.testing.assert_allclose(out.numpy(), x[4], rtol=1e-6)


def test_clippedclustering_empty_round_freezes_history():
    agg = get_aggregator("clippedclustering")
    x = torch.from_numpy(_matrix("plain", seed=10))
    _, st1 = agg.aggregate_masked(x, agg.init_state(K, D), mask=torch.ones(K, dtype=torch.bool))
    _, st2 = agg.aggregate_masked(x, st1, mask=torch.zeros(K, dtype=torch.bool))
    for n in ("norms", "pos", "count"):
        assert torch.equal(st2[n], st1[n])
    assert int(st1["count"]) == K


def test_fltrust_degrades_to_zero_when_trusted_client_drops():
    x = torch.from_numpy(_matrix("plain", seed=11))
    mask = torch.from_numpy(_mask((3,)))
    trusted = torch.from_numpy(np.arange(K) == 3)
    out, _ = get_aggregator("fltrust").aggregate_masked(x, mask=mask, trusted_mask=trusted)
    assert not out.any()


# -- SignGuard and ByzantineSGD, dense ------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "alie", "zeros"])
@pytest.mark.parametrize("k", [10, 11])
@pytest.mark.parametrize("kw", [{}, {"lower": 0.9, "upper": 1.1}], ids=["default", "tight"])
def test_signguard_dense_matches_jax(kw, k, kind):
    x = _matrix("alie" if kind == "alie" else "plain", seed=12, k=k)
    if kind == "zeros":
        x[::3, ::2] = 0.0  # the zero share moves; one row in three
        x[1] *= 4.0  # past the norm band's upper edge
    ours, ref = get_aggregator("signguard", **kw), jax_get_aggregator("signguard", **kw)
    got, _ = ours.aggregate(torch.from_numpy(x))
    expect, _ = ref.aggregate(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("kw", [{}, {"th_A": 0.05, "th_B": 0.8, "th_V": 0.25}],
                         ids=["default", "tight"])
def test_byzantinesgd_dense_three_rounds_match_jax(monkeypatch, kw):
    both = _Both("byzantinesgd", kw, monkeypatch)
    tstate, jstate = both.ours.init_state(K, D), both.ref.init_state(K, D)
    for rnd in range(3):
        x = _matrix("alie", seed=20 + rnd) * (1.0 + rnd)
        got, tstate, expect, jstate = both.run(x, None, tstate, jstate, rnd)
        np.testing.assert_allclose(got.numpy(), expect, **TOL)
        _assert_state(tstate, jstate)
    assert bool(tstate["initialized"])
    with pytest.raises(ValueError, match="params_flat"):
        both.ours.aggregate(torch.zeros(K, D), both.ours.init_state(K, D))


# -- the gossip aggregators -----------------------------------------------------------

TOPOLOGIES = {
    "ring": (lambda: decentralized.ring_adjacency(K), lambda: jax_decentralized.ring_adjacency(K)),
    "torus": (lambda: decentralized.torus_adjacency(3, 4),
              lambda: jax_decentralized.torus_adjacency(3, 4)),
    "full": (lambda: decentralized.fully_connected_adjacency(K),
             lambda: jax_decentralized.fully_connected_adjacency(K)),
}


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_decentralized_mixing_matches_jax(topology):
    ours_adj, ref_adj = (f() for f in TOPOLOGIES[topology])
    np.testing.assert_array_equal(ours_adj, ref_adj)
    w = decentralized.metropolis_weights(ours_adj)
    np.testing.assert_array_equal(w, jax_decentralized.metropolis_weights(ref_adj))
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-12)
    x = _matrix("alie", seed=13)
    ours, ref = decentralized.DecentralizedMixing(w), jax_decentralized.DecentralizedMixing(w)
    np.testing.assert_allclose(ours.mix(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.mix(jnp.asarray(x))), **TOL)
    got, _ = ours.aggregate(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.aggregate(jnp.asarray(x))[0]), **TOL)
    assert repr(ours) == repr(ref)


@pytest.mark.parametrize("tau", [10.0, 0.3])
@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_anchor_clipping_three_rounds_match_jax(topology, tau):
    w = decentralized.metropolis_weights(TOPOLOGIES[topology][0]())
    ours = decentralized.AnchorClipping(w, tau=tau)
    ref = jax_decentralized.AnchorClipping(w, tau=tau)
    tstate, jstate = ours.init_state(K, D), ref.init_state(K, D)
    for rnd in range(3):
        x = _matrix("plain", seed=14 + rnd) * (1.0 + rnd)
        got, tstate = ours.aggregate(torch.from_numpy(x), tstate)
        expect, jstate = ref.aggregate(jnp.asarray(x), jstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate), **TOL)
    assert repr(ours) == repr(ref)


def test_metropolis_weights_rejects_a_directed_graph():
    a = np.zeros((3, 3), bool)
    a[0, 1] = True
    with pytest.raises(ValueError, match="symmetric"):
        decentralized.metropolis_weights(a)


# -- the fault model ------------------------------------------------------------------


def _apply_both(monkeypatch, kw, x, tstate, jstate, rnd, seed=3):
    """``FaultModel(**kw).apply`` in both packages on ``x``, the port's draws
    (from a generator seeded ``seed + rnd``) handed to the JAX package's
    ``jax.random.bernoulli`` in call order. Returns both results."""
    fm, jfm = FaultModel(**kw), JaxFaultModel(**kw)
    k, d = x.shape
    draws = draw_faults(fm, k, d, torch.Generator().manual_seed(seed + rnd))
    queue = [draws[n].numpy() for n in ("drop", "straggle", "corrupt", "bitflip")
             if draws[n] is not None]

    def bernoulli(key, p=0.5, shape=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    ours = fm.apply(torch.from_numpy(x), tstate, None, rnd, draws=draws)
    ref = jfm.apply(jnp.asarray(x), jstate, jax.random.PRNGKey(0), rnd)
    assert queue == []  # the JAX side took every draw
    return ours, ref


def _assert_apply(ours, ref):
    (out, mask, state, diag), (jout, jmask, jstate, jdiag) = ours, ref
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))  # NaN == NaN here
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.dtype == torch.bool
    assert set(diag) == set(jdiag)
    for n, v in diag.items():
        assert v.dtype == torch.int32 and v.dim() == 0
        assert int(v) == int(jdiag[n]), n
    _assert_state(state, jstate, tol=dict(rtol=0.0, atol=0.0))


FAULT_CASES = {
    "dropout": dict(dropout_rate=0.4),
    "dropout+corrupt_rate": dict(dropout_rate=0.2, corrupt_rate=0.3),
    "nan": dict(corrupt_clients=(0, 1)),
    "inf": dict(corrupt_clients=(0, 1), corrupt_mode="inf"),
    "bitflip": dict(corrupt_clients=(0, 1), corrupt_mode="bitflip", bitflip_frac=0.2),
    "bitflip-no-victims": dict(corrupt_mode="bitflip", dropout_rate=0.3),
    "nan-unguarded": dict(corrupt_clients=(0, 1, 40), guard_nonfinite=False),
    "inf-rate-unguarded": dict(corrupt_rate=0.5, corrupt_mode="inf", guard_nonfinite=False),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_apply_matches_jax(monkeypatch, case):
    kw = FAULT_CASES[case]
    fm, jfm = FaultModel(**kw), JaxFaultModel(**kw)
    x = _matrix("plain", seed=15)
    jstate = jfm.init_state(K, D)
    ours, ref = _apply_both(monkeypatch, kw, x, fm.init_state(K, D), jstate, 0)
    _assert_apply(ours, ref)
    out, mask, _, diag = ours
    if "corrupt_clients" in kw:
        assert int(diag["corrupted"]) == 2
        assert not torch.equal(out[:2], torch.from_numpy(x[:2]))
        if kw.get("corrupt_mode", "nan") != "bitflip":
            assert bool(mask[:2].any()) == (not kw.get("guard_nonfinite", True))
    assert repr(fm) == repr(jfm)
    assert fm.static_fingerprint() == jfm.static_fingerprint()
    assert fm.value_corruption == jfm.value_corruption


def test_fault_straggler_replay_three_rounds_matches_jax(monkeypatch):
    """Dropout, stragglers (buffer bound 1) and NaN clients over 3 rounds:
    the port starts from the JAX package's initial state carried over; the
    received matrix, the mask, the counters and the buffer (stale, age,
    has, fill) agree bit for bit after every round, and stragglers replay."""
    kw = dict(dropout_rate=0.2, straggler_rate=0.5, max_staleness=1, corrupt_clients=(3,))
    jfm = JaxFaultModel(**kw)
    jstate = jfm.init_state(K, D)
    tstate = state_from_jax(jstate)
    _assert_state(FaultModel(**kw).init_state(K, D), jstate, tol=dict(rtol=0.0, atol=0.0))
    replayed = []
    for rnd in range(3):
        x = _matrix("plain", seed=16 + rnd)
        ours, ref = _apply_both(monkeypatch, kw, x, tstate, jstate, rnd)
        _assert_apply(ours, ref)
        tstate, jstate = ours[2], ref[2]
        replayed.append(int(ours[3]["stale_replayed"]))
        assert tstate["stale"].dtype == torch.float32
    assert replayed[0] == 0 and sum(replayed[1:]) > 0


def test_fault_straggler_buffer_expires():
    """Everyone straggles: round 0 has no buffer, so all expire; after a
    fresh round, replays until the buffer passes max_staleness."""
    fm = FaultModel(straggler_rate=1.0, max_staleness=2)
    u1, u2 = (torch.from_numpy(_matrix("plain", seed=s)) for s in (17, 18))
    g = torch.Generator().manual_seed(0)
    _, _, _, d0 = fm.apply(u1, fm.init_state(K, D), g, 0)
    assert int(d0["participants"]) == 0 and int(d0["stragglers_expired"]) == K
    _, m1, st, _ = FaultModel(straggler_rate=1e-9, max_staleness=2).apply(
        u1, fm.init_state(K, D), g, 1)
    assert bool(m1.all())
    out2, _, st2, d2 = fm.apply(u2, st, g, 2)
    assert int(d2["stale_replayed"]) == K and torch.equal(out2, u1)
    _, _, st3, d3 = fm.apply(u2, st2, g, 3)
    assert int(d3["stale_replayed"]) == K
    _, m4, _, d4 = fm.apply(u2, st3, g, 4)
    assert int(d4["stragglers_expired"]) == K and not bool(m4.any())


def test_fault_participation_schedule_matches_jax(monkeypatch):
    sched = np.zeros((2, K), bool)
    sched[0, :4] = True
    sched[1, 4:] = True
    kw = dict(participation_schedule=sched)
    x = _matrix("plain", seed=19)
    for rnd in range(3):
        ours, ref = _apply_both(monkeypatch, kw, x, (), (), rnd)
        _assert_apply(ours, ref)
        assert ours[1].tolist() == sched[rnd % 2].tolist()
    assert int(ours[3]["participants"]) == 4 and int(ours[3]["dropped"]) == K - 4


def test_fault_model_validation_and_state():
    with pytest.raises(ValueError, match="corrupt_mode"):
        FaultModel(corrupt_mode="frobnicate")
    with pytest.raises(ValueError, match="participation_schedule"):
        FaultModel(participation_schedule=np.ones(4, bool))
    fm = FaultModel(corrupt_clients=[1, np.int64(2)])
    assert fm.corrupt_clients == (1, 2)
    assert FaultModel().init_state(K, D) == () and not FaultModel().has_stragglers
    assert repr(FaultModel()) == repr(JaxFaultModel()) == "FaultModel(noop)"
    st = FaultModel(corrupt_rate=0.1, corrupt_mode="inf").init_state(K, D)
    assert set(st) == {"fill"} and float(st["fill"]) == float("inf")


def test_fault_draws_are_seeded():
    fm = FaultModel(dropout_rate=0.4, straggler_rate=0.3, corrupt_rate=0.2, corrupt_mode="bitflip")
    a = draw_faults(fm, K, D, torch.Generator().manual_seed(1))
    b = draw_faults(fm, K, D, torch.Generator().manual_seed(1))
    c = draw_faults(fm, K, D, torch.Generator().manual_seed(2))
    assert [t.shape for t in a.values()] == [(K,), (K,), (K,), (K, D)]
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not all(torch.equal(a[n], c[n]) for n in a)
    assert draw_faults(FaultModel(), K, D, torch.Generator()) == dict.fromkeys(a)


def test_nonfinite_guard_keeps_the_masked_median_clean():
    fm = FaultModel(corrupt_clients=(0, 1), corrupt_mode="nan")
    x = torch.from_numpy(_matrix("plain", seed=20))
    out, mask, _, diag = fm.apply(x, fm.init_state(K, D), torch.Generator(), 0)
    assert int(diag["excluded_nonfinite"]) == 2 and int(diag["participants"]) == K - 2
    agg, _ = get_aggregator("median").aggregate_masked(out, mask=mask)
    np.testing.assert_allclose(agg.numpy(), np.median(x.numpy()[2:], axis=0), rtol=1e-6)
