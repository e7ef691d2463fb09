"""The aggregators' forensics against the JAX package's.

``diagnostics``, ``aggregate_with_diagnostics`` and
``aggregate_masked_with_diagnostics`` of the four defenses that record what
they decided (trimmed mean's trim counts, Krum's and Multi-Krum's scores and
selection, centered clipping's clip norms, FLTrust's trust scores), dense and
masked with NaN rows masked out, on the same numpy-seeded inputs handed to
both packages. Integers exactly (``trim_counts`` on ALIE's tied rows
included, ``selected`` on inputs without repeated rows), floats at f32
``rtol = atol = 1e-5``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator, trimmedmean
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
K, D = 11, 53

CASES = [
    ("trimmedmean", {"num_byzantine": 3}),
    ("trimmedmean", {"num_byzantine": 1}),
    ("krum", {"num_byzantine": 2}),
    ("multikrum", {"num_byzantine": 2, "num_selected": 4}),
    ("centeredclipping", {"tau": 0.5}),
    ("fltrust", {}),
]


def _id(case):
    name, kw = case
    return "-".join([name] + [f"{k}{v}" for k, v in sorted(kw.items())])


def _matrix(seed, k=K, d=D, ties=0):
    """Seeded ``[k, d]`` float32 updates; the first ``ties`` rows are one
    row repeated (ALIE writes its f rows so)."""
    r = np.random.RandomState(seed)
    u = (r.randn(k, d) * r.uniform(0.2, 2.0, (k, 1))).astype(np.float32)
    if ties:
        u[:ties] = u[0]
    return u


def _ctx(name, k=K, trusted=4):
    if name != "fltrust":
        return {}, {}
    tm = np.zeros(k, bool)
    tm[trusted] = True
    return {"trusted_mask": torch.tensor(tm)}, {"trusted_mask": jnp.asarray(tm)}


def _pair(name, kw, k=K, d=D, state_seed=None):
    """The port's and the JAX aggregator with their states; centered
    clipping's momentum seeded, so its diagnostics measure from a centre."""
    ours, ref = get_aggregator(name, **kw), jax_get_aggregator(name, **kw)
    s_t, s_j = ours.init_state(k, d), ref.init_state(k, d)
    if name == "centeredclipping" and state_seed is not None:
        v = np.random.RandomState(state_seed).randn(d).astype(np.float32) * 0.1
        s_t, s_j = torch.tensor(v), jnp.asarray(v)
    return ours, ref, s_t, s_j


def _assert_diag(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        mine = got[name].numpy()
        assert mine.shape == ref.shape and mine.dtype == ref.dtype, name
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(mine, ref, err_msg=name)
        else:
            np.testing.assert_allclose(mine, ref, err_msg=name, **TOL)


def test_diagnostic_defenses_are_registered():
    for name, _ in CASES:
        assert name in AGGREGATORS
    assert get_aggregator("mean").diagnostics(torch.zeros(3, 4)) == {}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_dense_diagnostics_match_jax(case, seed):
    name, kw = case
    u = _matrix(seed)
    ours, ref, s_t, s_j = _pair(name, kw, state_seed=seed)
    ctx_t, ctx_j = _ctx(name)
    agg_t, _, diag_t = ours.aggregate_with_diagnostics(torch.tensor(u), s_t, **ctx_t)
    agg_j, _, diag_j = ref.aggregate_with_diagnostics(jnp.asarray(u), s_j, **ctx_j)
    _assert_diag(diag_t, diag_j)
    np.testing.assert_allclose(agg_t.numpy(), np.asarray(agg_j), **TOL)


MASKS = {
    "two-off": [0, 3],
    "nan-rows-off": [1, 6],
    "one-left-in": list(range(1, K)),
}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_masked_diagnostics_match_jax(case, mask):
    """The masked form's diagnostics run on the sanitized matrix: a NaN row
    that is masked out reaches neither package's forensics."""
    name, kw = case
    u = _matrix(7)
    off = MASKS[mask]
    if mask == "nan-rows-off":
        u[off] = np.nan
    m = np.ones(K, bool)
    m[off] = False
    ours, ref, s_t, s_j = _pair(name, kw, state_seed=3)
    ctx_t, ctx_j = _ctx(name)
    agg_t, _, diag_t = ours.aggregate_masked_with_diagnostics(
        torch.tensor(u), s_t, mask=torch.tensor(m), **ctx_t)
    agg_j, _, diag_j = ref.aggregate_masked_with_diagnostics(
        jnp.asarray(u), s_j, mask=jnp.asarray(m), **ctx_j)
    _assert_diag(diag_t, diag_j)
    for v in diag_t.values():
        assert not v.is_floating_point() or bool(torch.isfinite(v).all())
    np.testing.assert_allclose(agg_t.numpy(), np.asarray(agg_j), **TOL)


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("ties", [2, 5])
def test_trim_counts_exact_on_tied_rows(ties, b):
    """ALIE writes f identical rows, so every column ties: the counts follow
    JAX's stable ranks exactly (ties to the lower client index), -0.0 and
    0.0 tied as JAX's sort comparator ties them."""
    u = _matrix(11, k=13, d=97, ties=ties)
    u[5, :10] = 0.0
    u[6, :10] = -0.0  # equal to 0.0 in JAX's sort
    ours = get_aggregator("trimmedmean", num_byzantine=b)
    ref = jax_get_aggregator("trimmedmean", num_byzantine=b)
    got = ours.diagnostics(torch.tensor(u))
    want = ref.diagnostics(jnp.asarray(u))
    np.testing.assert_array_equal(got["trim_counts"].numpy(), np.asarray(want["trim_counts"]))
    assert int(got["trim_b"]) == int(want["trim_b"]) == b
    assert int(got["trim_counts"].sum()) == 2 * b * 97


@pytest.mark.parametrize("slab", [9, 9 * 7, 9 * 301])
def test_trim_counts_over_column_slabs(monkeypatch, slab):
    """Columns sorted in slabs (one column, 7 columns, a ragged last slab,
    or one D-wide slab): the same counts as JAX's one pass."""
    monkeypatch.setattr(trimmedmean, "TRIM_SLAB_ELEMS", slab)
    u = _matrix(5, k=9, d=301, ties=3)
    one = get_aggregator("trimmedmean", num_byzantine=2).diagnostics(torch.tensor(u))
    big = np.concatenate([u] * 4, axis=1)
    four = get_aggregator("trimmedmean", num_byzantine=2).diagnostics(torch.tensor(big))
    assert torch.equal(four["trim_counts"], one["trim_counts"] * 4)
    want = jax_get_aggregator("trimmedmean", num_byzantine=2).diagnostics(jnp.asarray(big))
    np.testing.assert_array_equal(four["trim_counts"].numpy(), np.asarray(want["trim_counts"]))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_aggregate_with_diagnostics_is_aggregate_plus_diagnostics(case):
    name, kw = case
    u = torch.tensor(_matrix(4))
    ours, _, s_t, _ = _pair(name, kw, state_seed=4)
    ctx_t, _ = _ctx(name)
    agg, state, diag = ours.aggregate_with_diagnostics(u, s_t, **ctx_t)
    agg2, state2 = ours.aggregate(u, s_t, **ctx_t)
    diag2 = ours.diagnostics(u, s_t, **ctx_t)
    assert torch.equal(agg, agg2)
    assert sorted(diag) == sorted(diag2)
    for n in diag:
        assert torch.equal(diag[n], diag2[n])
    if isinstance(state, torch.Tensor):
        assert torch.equal(state, state2)
    # without a mask the masked form is the dense one
    agg3, _, diag3 = ours.aggregate_masked_with_diagnostics(u, s_t, mask=None, **ctx_t)
    assert torch.equal(agg3, agg) and all(torch.equal(diag3[n], diag[n]) for n in diag)


def test_krum_selection_names_the_applied_rows():
    """Krum's recorded selection is the one its aggregate averages."""
    u = torch.tensor(_matrix(9))
    agg = get_aggregator("multikrum", num_byzantine=2, num_selected=3)
    out, _, diag = agg.aggregate_with_diagnostics(u)
    assert diag["selected"].dtype == torch.int32 and diag["selected"].shape == (3,)
    assert torch.allclose(out, u[diag["selected"].long()].mean(dim=0))


def test_fltrust_without_trusted_mask_records_nothing():
    assert get_aggregator("fltrust").diagnostics(torch.tensor(_matrix(0))) == {}
