"""The port's dense aggregators and their ops against the JAX package, on the
same seeded-numpy ``[K, D]`` matrices.

Inputs: K even (10) and odd (11); a plain Gaussian matrix, one with
ALIE-style identical rows (the first four rows are one vector), and one
with ties (entries on a coarse grid, so columns hold equal values and rows
repeat). Tolerances: f32 ``rtol=atol=1e-5`` (the two frameworks sum in
other orders); GeoMed and AutoGM ``rtol=1e-4, atol=1e-6``, since their
loops compound the rounding over up to 100 iterations. Krum's selections
and the clustering partitions must be identical. The stateful aggregators
run 3 rounds, and their state is compared after each. DnC's random
coordinates and start vectors are drawn by the port and handed to the JAX
package by patching ``jax.random.choice`` and ``jax.random.normal``, with
JAX's loops run eagerly (``jax.disable_jit``) so each iteration takes its
own draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.ops import clustering as jax_clustering
from blades_tpu.ops import distances as jax_distances
from blades_tpu_torch.aggregators import AGGREGATORS, UNPORTED, get_aggregator
from blades_tpu_torch.aggregators.dnc import draw_subspaces
from blades_tpu_torch.ops import clustering, distances
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-6)  # GeoMed, AutoGM
F = 2
D = 40


def _matrix(k, kind, seed=0, d=D):
    rng = np.random.RandomState(seed + 17 * k)
    x = (rng.randn(k, d) * 0.1).astype(np.float32)
    if kind == "alie":
        x[:4] = x[0]
    elif kind == "ties":
        x = (np.round(x * 20) / 20).astype(np.float32)
        x[3] = x[1]
        x[k - 1] = x[k - 2]
    return x


def _both(name, **kw):
    return get_aggregator(name, **kw), jax_get_aggregator(name, **kw)


def _ctx(k):
    mask = np.arange(k) == k - 1
    return dict(trusted_mask=torch.from_numpy(mask)), dict(trusted_mask=jnp.asarray(mask))


STATELESS = [
    ("median", {}, TOL),
    ("krum", dict(num_byzantine=F), TOL),
    ("krum", dict(num_byzantine=F, distance_power=4), TOL),
    ("multikrum", dict(num_byzantine=F, num_selected=3), TOL),
    ("geomed", {}, LOOP_TOL),
    ("autogm", {}, LOOP_TOL),
    ("clustering", dict(metric="similarity"), TOL),
    ("clustering", dict(metric="distance"), TOL),
    ("fltrust", {}, TOL),
]


@pytest.mark.parametrize("kind", ["plain", "alie", "ties"])
@pytest.mark.parametrize("k", [10, 11])
@pytest.mark.parametrize("name,kw,tol", STATELESS,
                         ids=[f"{n}-{'-'.join(f'{a}{b}' for a, b in kw.items())}"
                              for n, kw, _ in STATELESS])
def test_stateless_aggregator_matches_jax(name, kw, tol, k, kind):
    x = _matrix(k, kind)
    ours, ref = _both(name, **kw)
    tctx, jctx = _ctx(k) if name == "fltrust" else ({}, {})
    got, state = ours.aggregate(torch.from_numpy(x), (), **tctx)
    expect, _ = ref.aggregate(jnp.asarray(x), (), **jctx)
    assert state == () and got.shape == (D,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **tol)


@pytest.mark.parametrize("kind", ["plain", "alie", "ties"])
@pytest.mark.parametrize("k", [10, 11])
@pytest.mark.parametrize("m,power", [(1, 2), (1, 4), (3, 2)])
def test_krum_selection_identical(m, power, k, kind):
    """The same clients, in the same order. Identical rows score alike up to
    rounding, which differs between the frameworks, so where two selected
    clients differ their rows must be identical."""
    x = _matrix(k, kind)
    ours, ref = _both("krum", num_byzantine=F, num_selected=m, distance_power=power)
    scores, sel = ours._select(torch.from_numpy(x))
    jscores, jsel = ref._select(jnp.asarray(x))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-6)
    sel, jsel = sel.numpy(), np.asarray(jsel)
    np.testing.assert_array_equal(x[sel], x[jsel])
    if kind == "plain":
        np.testing.assert_array_equal(sel, jsel)


@pytest.mark.parametrize("kind", ["plain", "alie", "ties"])
@pytest.mark.parametrize("k", [10, 11])
@pytest.mark.parametrize("metric", ["similarity", "distance"])
def test_clustering_partition_identical(metric, k, kind):
    x = _matrix(k, kind)
    ours, ref = _both("clustering", metric=metric)
    m = ours._matrix(torch.from_numpy(x))
    jm = ref._matrix(jnp.asarray(x))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    # the same matrix into both linkages: the partition must match exactly
    labels = clustering.complete_linkage_two_clusters(m)
    jlabels = jax_clustering.complete_linkage_two_clusters(jnp.asarray(m.numpy()))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_array_equal(
        labels.numpy(),
        np.asarray(jax_clustering.complete_linkage_two_clusters(jm)),
    )


def test_complete_linkage_tie_order_matches_jax():
    """A distance matrix whose entries tie exactly: the first index among
    equal minima merges first in both packages, so the partitions match."""
    d = np.array([[0, 1, 1, 2, 2, 2],
                  [1, 0, 1, 2, 2, 2],
                  [1, 1, 0, 2, 2, 2],
                  [2, 2, 2, 0, 1, 1],
                  [2, 2, 2, 1, 0, 1],
                  [2, 2, 2, 1, 1, 0]], dtype=np.float32)
    for perm in ([0, 1, 2, 3, 4, 5], [5, 0, 4, 1, 3, 2], [2, 3, 1, 4, 0, 5]):
        p = d[np.ix_(perm, perm)]
        labels = clustering.complete_linkage_two_clusters(torch.from_numpy(p)).numpy()
        jlabels = np.asarray(jax_clustering.complete_linkage_two_clusters(jnp.asarray(p)))
        np.testing.assert_array_equal(labels, jlabels)
        assert labels[0] == 0 and labels.sum() == 3


@pytest.mark.parametrize("k", [10, 11])
def test_majority_cluster_mean_matches_jax(k):
    x = _matrix(k, "plain")
    for labels in (np.arange(k) % 2, (np.arange(k) < k // 2).astype(np.int64),
                   np.zeros(k, np.int64)):
        got = clustering.majority_cluster_mean(torch.from_numpy(x), torch.from_numpy(labels))
        expect = jax_clustering.majority_cluster_mean(jnp.asarray(x), jnp.asarray(labels))
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("kind", ["plain", "alie"])
def test_distances_match_jax(kind):
    x = _matrix(10, kind)
    x[5] = 0.0  # a zero row: cosine clamps its norm
    for ours, ref in ((distances.pairwise_sq_euclidean, jax_distances.pairwise_sq_euclidean),
                      (distances.pairwise_cosine_similarity,
                       jax_distances.pairwise_cosine_similarity)):
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("k", [10, 11])
def test_geomed_weights_ctx_matches_jax(k):
    x = _matrix(k, "plain")
    w = np.random.RandomState(3).rand(k).astype(np.float32)
    w /= w.sum()
    ours, ref = _both("geomed")
    got, _ = ours.aggregate(torch.from_numpy(x), weights=torch.from_numpy(w))
    expect, _ = ref.aggregate(jnp.asarray(x), weights=jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **LOOP_TOL)
    assert 1 <= ours.last_iterations <= ours.maxiter
    unweighted, _ = ours.aggregate(torch.from_numpy(x))
    assert not torch.allclose(got, unweighted)


def _patched_draws(monkeypatch, draws):
    """Hand ``draws`` (port tensors) to the JAX package in call order:
    ``jax.random.choice`` then ``jax.random.normal``, per iteration."""
    queue = [t.numpy() for pair in draws for t in pair]

    def take(kind):
        def fn(key, *args, **kwargs):
            arr = queue.pop(0)
            assert (kind == "choice") == (arr.dtype == np.int64), kind
            return jnp.asarray(arr.astype(np.int32) if kind == "choice" else arr)
        return fn

    monkeypatch.setattr(jax.random, "choice", take("choice"))
    monkeypatch.setattr(jax.random, "normal", take("normal"))
    return queue


@pytest.mark.parametrize("kind", ["plain", "alie"])
@pytest.mark.parametrize("k,f,sub_dim", [(10, 2, 16), (11, 3, 40)])
def test_dnc_matches_jax_with_injected_draws(monkeypatch, k, f, sub_dim, kind):
    x = _matrix(k, kind)
    ours = get_aggregator("dnc", num_byzantine=f, sub_dim=sub_dim, num_iters=3)
    ref = jax_get_aggregator("dnc", num_byzantine=f, sub_dim=sub_dim, num_iters=3)
    seed = 5
    draws = draw_subspaces(torch.Generator().manual_seed(seed), 3, D, min(sub_dim, D), "cpu")
    got, _ = ours.aggregate(torch.from_numpy(x), generator=torch.Generator().manual_seed(seed))
    queue = _patched_draws(monkeypatch, draws)
    with jax.disable_jit():
        expect, _ = ref.aggregate(jnp.asarray(x), key=jax.random.key(0))
    assert queue == []  # every draw was taken, in order
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("name,kw", [
    ("centeredclipping", {}),
    ("centeredclipping", dict(tau=0.2, n_iter=3)),
    ("clippedclustering", {}),
    ("clippedclustering", dict(tau=0.25)),
    ("clippedclustering", dict(history_cap=24)),  # the ring wraps in round 3
])
@pytest.mark.parametrize("k", [10, 11])
def test_stateful_aggregator_three_rounds_match_jax(name, kw, k):
    ours, ref = _both(name, **kw)
    state, jstate = ours.init_state(k, D), ref.init_state(k, D)
    for rnd in range(3):
        x = _matrix(k, "alie", seed=rnd) * (1.0 + rnd)
        got, state = ours.aggregate(torch.from_numpy(x), state)
        expect, jstate = ref.aggregate(jnp.asarray(x), jstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
        if name == "centeredclipping":
            np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
        else:
            np.testing.assert_allclose(state["norms"].numpy(), np.asarray(jstate["norms"]),
                                       **TOL)
            assert int(state["pos"]) == int(jstate["pos"])
            assert int(state["count"]) == int(jstate["count"])


def test_median_propagates_nan_as_jnp_median():
    """A column holding a NaN has a NaN median (``jnp.median``); one holding
    an Inf a finite one. ``torch.sort`` puts NaN last, so a bare midpoint of
    the sort would give 2.5 in the first column."""
    x = np.array([[1, 2], [np.nan, 3], [4, 5], [0.5, np.inf]], np.float32)
    got, _ = get_aggregator("median").aggregate(torch.from_numpy(x))
    expect, _ = jax_get_aggregator("median").aggregate(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(expect), [np.nan, 4.0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    for k in (10, 11):  # one NaN, one Inf, one -Inf among Gaussian columns
        y = _matrix(k, "plain")
        y[3, 5], y[7, 9], y[2, 11] = np.nan, np.inf, -np.inf
        got, _ = get_aggregator("median").aggregate(torch.from_numpy(y))
        expect, _ = jax_get_aggregator("median").aggregate(jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), equal_nan=True, **TOL)
        assert np.isnan(got.numpy()).tolist() == [j == 5 for j in range(D)]


@pytest.mark.parametrize("n", [3, 4, 7, 8])
def test_clippedclustering_history_median_is_the_live_midpoint(n):
    from blades_tpu_torch.aggregators.clippedclustering import masked_median

    norms = torch.zeros(16)
    norms[:n] = torch.tensor([5.0, 1.0, 4.0, 2.0, 8.0, 3.0, 7.0, 6.0][:n])
    got = masked_median(norms, torch.tensor(n, dtype=torch.int32))
    assert float(got) == float(np.median(norms[:n].numpy()))


def test_fltrust_host_guard_and_trusted_mask():
    x = _matrix(10, "plain")
    ours, ref = _both("fltrust")
    two = np.zeros(10, bool)
    two[[1, 2]] = True
    for agg, mask in ((ours, torch.from_numpy(two)), (ref, jnp.asarray(two))):
        with pytest.raises(ValueError, match="exactly one trusted"):
            agg(x, trusted_mask=mask)
    with pytest.raises(ValueError, match="trusted_mask"):
        ours.aggregate(torch.from_numpy(x))
    tctx, jctx = _ctx(10)
    got = ours(torch.from_numpy(x), **tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(x), **jctx)), **TOL)
    # every untrusted update opposed to the trusted one: the zero vector
    opposed = np.tile(-x[9:], (10, 1))
    opposed[9] = x[9]
    zero, _ = ours.aggregate(torch.from_numpy(opposed), **tctx)
    assert not zero.any()


def test_registry_resolves_the_catalog():
    names = ("median", "krum", "multikrum", "geomed", "autogm", "centeredclipping",
             "clustering", "clippedclustering", "fltrust", "dnc", "mean", "trimmedmean",
             "byzantinesgd", "signguard", "asyncmean", "asynccenteredclipping")
    assert set(AGGREGATORS) == set(names)
    for name in names:
        assert isinstance(get_aggregator(name), AGGREGATORS[name])
    # the async pair is ported (slice 9): nothing of the registry is left
    assert UNPORTED == {}
    # streaming is ported: a defense without a streaming form names its reason
    assert get_aggregator("median").supports_streaming()
    with pytest.raises(NotImplementedError, match="per-client B accumulators"):
        get_aggregator("byzantinesgd").streaming_update({}, torch.zeros(3, 2),
                                                        chunk_mask=torch.ones(3, dtype=bool),
                                                        chunk_index=0)
