"""The in-round metric pack (``telemetry/metric_pack.py``) against the JAX
package's, and across the port's own execution schedules.

Each pack function on the same numpy-seeded inputs handed to both packages:
integer fields (histogram, counts) exactly, float fields at f32
``rtol = atol = 1e-5``; norms that sit exactly on a bin edge land in the
bin JAX's ``searchsorted`` (side left, float32 edges) puts them in. Then
engine rounds of a tiny linear model: the dense round, a block of it and
the streaming round of the same rows give the same elementwise fields
(norms, histogram, extremes, counts) bit for bit, as the JAX package's
dense, block and streaming rounds do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.telemetry import metric_pack as jax_mp
from blades_tpu_torch.core import RoundEngine
from blades_tpu_torch.datasets import FLDataset
from blades_tpu_torch.ops.pytree import FlatLayout, LeafSpec
from blades_tpu_torch.ops.streaming import chunk_layout
from blades_tpu_torch.telemetry import metric_pack as mp
from blades_tpu_torch.utils import rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ELEMENTWISE = ("norm_q", "norm_hist", "n_participants", "n_masked_out", "slab_absmax",
               "slab_norm_max")


def _inputs(seed, k, d, off=(), nan_off=False):
    r = np.random.RandomState(seed)
    u = (r.randn(k, d) * np.logspace(-6, 3, k)[:, None]).astype(np.float32)
    m = np.ones(k, bool)
    m[list(off)] = False
    if nan_off and off:
        u[list(off)] = np.nan
    byz = np.arange(k) < max(1, k // 4)
    agg = r.randn(d).astype(np.float32)
    return u, m, byz, agg


def _assert_pack(got, want, exact_floats=False):
    for name in mp.MetricPack._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if b.dtype.kind in "biu" or exact_floats:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_constants_match_jax():
    assert mp.NBINS == jax_mp.NBINS
    np.testing.assert_array_equal(mp._EDGES, jax_mp._EDGES)
    assert mp.MetricPack._fields == jax_mp.MetricPack._fields


@pytest.mark.parametrize("chunks", [1, 3])
def test_pack_init_and_update_match_jax(chunks):
    k, d = 9, 40
    u, m, byz, _ = _inputs(0, k, d, off=(2,))
    c, cs, pad = chunk_layout(k, chunks)
    up = np.pad(u, ((0, pad), (0, 0)))
    mk, bz = np.pad(m, (0, pad)), np.pad(byz, (0, pad))
    carry, jcarry = mp.pack_init(c, d), jax_mp.pack_init(c, d)
    for j in range(c):
        rows = slice(j * cs, (j + 1) * cs)
        slab = np.where(mk[rows, None], up[rows], 0.0).astype(np.float32)
        carry, norms = mp.pack_update(carry, torch.tensor(slab), torch.tensor(mk[rows]),
                                      torch.tensor(bz[rows]), j)
        jcarry, jnorms = jax_mp.pack_update(jcarry, jnp.asarray(slab), jnp.asarray(mk[rows]),
                                            jnp.asarray(bz[rows]), jnp.asarray(j, jnp.int32))
        np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), **TOL)
    assert sorted(carry) == sorted(jcarry)
    for name in carry:
        np.testing.assert_allclose(carry[name].numpy(), np.asarray(jcarry[name]), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 5, 12])
def test_pack_finalize_matches_jax(n_valid):
    k, d = 12, 30
    r = np.random.RandomState(n_valid)
    norms = (10.0 ** r.uniform(-9, 9, k)).astype(np.float32)
    valid = np.zeros(k, bool)
    valid[r.permutation(k)[:n_valid]] = True
    norms = np.where(valid, norms, 0.0).astype(np.float32)
    sums = r.randn(2, d).astype(np.float32)
    counts = np.array([n_valid, 0 if n_valid < 3 else 2], np.float32)
    agg = r.randn(d).astype(np.float32)
    carry = {"sum_honest": torch.tensor(sums[0]), "sum_byz": torch.tensor(sums[1]),
             "n_honest": torch.tensor(counts[0]), "n_byz": torch.tensor(counts[1]),
             "slab_absmax": torch.tensor([1.5, 2.5]), "slab_norm_max": torch.tensor([3.0, 4.0])}
    jcarry = {n: jnp.asarray(v.numpy()) for n, v in carry.items()}
    got = mp.pack_finalize(carry, torch.tensor(norms), torch.tensor(valid), torch.tensor(agg))
    want = jax_mp.pack_finalize(jcarry, jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(agg))
    _assert_pack(got, want)
    # the quantiles pick order statistics of identical inputs: exact
    np.testing.assert_array_equal(got.norm_q.numpy(), np.asarray(want.norm_q))
    assert int(got.norm_hist.sum()) == n_valid


def test_bin_edges_are_hit_exactly():
    """A norm equal to an edge goes where JAX's ``searchsorted`` puts it
    (side left: into the bin below the edge), at every edge, and so do its
    float32 neighbours on either side."""
    edges = np.float32(mp._EDGES)
    norms = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(0)), [0.0, np.inf]]).astype(np.float32)
    k = norms.shape[0]
    valid = np.ones(k, bool)
    carry = mp.pack_init(1, 3)
    jcarry = jax_mp.pack_init(1, 3)
    agg = np.ones(3, np.float32)
    got = mp.pack_finalize(carry, torch.tensor(norms), torch.tensor(valid), torch.tensor(agg))
    want = jax_mp.pack_finalize(jcarry, jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(agg))
    np.testing.assert_array_equal(got.norm_hist.numpy(), np.asarray(want.norm_hist))
    # one edge value per interior bin boundary: bins 0..16 each hold an edge
    assert torch.equal(mp.edges("cpu"), torch.tensor(edges))  # made on the device
    bins = torch.searchsorted(mp.edges("cpu"), torch.tensor(edges))
    assert bins.tolist() == list(range(mp.NBINS - 1))
    # a row whose norm is exactly an edge, through pack_dense
    u = np.zeros((mp.NBINS - 1, 4), np.float32)
    u[:, 0] = edges
    pd = mp.pack_dense(torch.tensor(u), torch.ones(len(u), dtype=torch.bool),
                       torch.zeros(len(u), dtype=torch.bool), torch.tensor(agg[:1].repeat(4)),
                       1, len(u))
    jpd = jax_mp.pack_dense(jnp.asarray(u), jnp.ones(len(u), bool), jnp.zeros(len(u), bool),
                            jnp.ones(4, jnp.float32), 1, len(u))
    np.testing.assert_array_equal(pd.norm_hist.numpy(), np.asarray(jpd.norm_hist))


CASES = {
    "all-1chunk": dict(k=10, chunks=1, off=()),
    "all-3chunks": dict(k=10, chunks=3, off=()),
    "masked-4chunks": dict(k=11, chunks=4, off=(0, 5, 10)),
    "nan-masked-2chunks": dict(k=9, chunks=2, off=(3, 4), nan_off=True),
    "none-participate": dict(k=6, chunks=2, off=tuple(range(6))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_dense_and_fields_match_jax(case):
    kw = dict(CASES[case])
    k, chunks = kw.pop("k"), kw.pop("chunks")
    u, m, byz, agg = _inputs(3, k, 57, **kw)
    c, cs, _ = chunk_layout(k, chunks)
    got = mp.pack_dense(torch.tensor(u), torch.tensor(m), torch.tensor(byz), torch.tensor(agg),
                        c, cs)
    want = jax_mp.pack_dense(jnp.asarray(u), jnp.asarray(m), jnp.asarray(byz),
                             jnp.asarray(agg), c, cs)
    _assert_pack(got, want)
    for field in ("norm_q", "slab_norm_max", "cos_honest", "cos_byz"):
        assert np.isfinite(getattr(got, field).numpy()).all()
    fields, jfields = mp.pack_to_fields(got), jax_mp.pack_to_fields(want)
    assert sorted(fields) == sorted(jfields)
    for name, v in jfields.items():
        assert type(fields[name]) is type(v), name
        if isinstance(v, int) or name == "norm_hist":
            assert fields[name] == v, name
        else:
            np.testing.assert_allclose(fields[name], v, err_msg=name, **TOL)


def test_pack_dense_rejects_another_layout():
    with pytest.raises(ValueError, match="layout"):
        mp.pack_dense(torch.zeros(10, 3), torch.ones(10, dtype=torch.bool),
                      torch.zeros(10, dtype=torch.bool), torch.zeros(3), 3, 3)


def test_pack_to_fields_takes_host_arrays():
    u, m, byz, agg = _inputs(1, 8, 20)
    pack = mp.pack_dense(torch.tensor(u), torch.tensor(m), torch.tensor(byz),
                         torch.tensor(agg), 2, 4)
    host = mp.MetricPack(*(t.numpy() for t in pack))
    assert mp.pack_to_fields(host) == mp.pack_to_fields(pack)


# -- within the port: dense == block == streaming ---------------------------

K, F, C, SEED, S, B = 7, 10, 3, 5, 2, 4
LAYOUT = FlatLayout((LeafSpec("w", ("w",), (F, C)),))


def _loss(p, x, y, noise):
    logits = x.reshape(x.shape[0], -1) @ p["w"]
    loss = -torch.log_softmax(logits, -1).gather(-1, y.long()[:, None]).mean()
    return loss, {"top1": (logits.argmax(-1) == y).to(torch.float32).mean()}


def _logits(p, x):
    return x.reshape(x.shape[0], -1) @ p["w"]


def _setup(**kw):
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.attackers import get_attack

    r = np.random.RandomState(0)
    ds = FLDataset(r.randn(K, 16, F).astype(np.float32),
                   r.randint(0, C, (K, 16)).astype(np.int64), np.full(K, 16, np.int64),
                   r.randn(20, F).astype(np.float32), r.randint(0, C, 20).astype(np.int64),
                   device="cpu")
    w0 = {"w": torch.from_numpy(r.randn(F, C).astype(np.float32) * 0.1)}
    eng = RoundEngine(_loss, _logits, w0, LAYOUT, num_clients=K, num_byzantine=2,
                      attack=get_attack("signflipping"),
                      aggregator=get_aggregator("mean"), num_classes=C, device="cpu",
                      client_chunks=3, round_metrics=True, **kw)
    return ds, w0, eng


def _rounds(ds, w0, eng, rounds=3):
    st, packs = eng.init(w0), []
    for r in range(1, rounds + 1):
        cx, cy = ds.sample_round(rng.generator(SEED, r, rng.DATA), S, B)
        st, _ = eng.run_round(st, cx, cy, 0.1, 1.0, SEED)
        packs.append(eng.last_metric_pack)
    return st, packs


@pytest.mark.parametrize("faults", [None, {"corrupt_clients": (3,), "corrupt_mode": "nan"}],
                         ids=["clean", "nan-client"])
def test_dense_block_and_streaming_packs_are_bit_identical(faults):
    from blades_tpu_torch.faults import FaultModel

    fm = (lambda: FaultModel(**faults)) if faults else (lambda: None)
    ds, w0, dense = _setup(fault_model=fm())
    st, packs = _rounds(ds, w0, dense)
    # a block of the same rounds: every field, bit for bit
    _, _, diags = dense.run_block(dense.init(w0), [1, 2, 3], [0.1] * 3, [1.0] * 3, SEED,
                                  sampler=ds.sampler(S, B))
    for i, pack in enumerate(packs):
        for name in mp.MetricPack._fields:
            assert torch.equal(getattr(diags["metrics"], name)[i], getattr(pack, name)), name
    # the streaming round of the same rows (the first round: same params)
    _, _, stream = _setup(fault_model=fm(), streaming=True)
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA), S, B)
    stream.run_round(stream.init(w0), cx, cy, 0.1, 1.0, SEED)
    for name in ELEMENTWISE:
        assert torch.equal(getattr(stream.last_metric_pack, name), getattr(packs[0], name)), name
    # the mean's streaming form is the dense estimator up to the order of
    # its sums, so the cosines to it agree to rounding
    for name in ("cos_honest", "cos_byz"):
        torch.testing.assert_close(getattr(stream.last_metric_pack, name),
                                   getattr(packs[0], name), rtol=1e-5, atol=1e-6)
    assert int(packs[0].n_participants) == (K - 1 if faults else K)


def test_pack_is_off_by_default_and_measures_the_applied_aggregate():
    ds, w0, eng = _setup()
    st, packs = _rounds(ds, w0, eng, rounds=1)
    u = eng.last_updates
    agg = (st.params["w"] - w0["w"]).reshape(-1)  # server SGD, lr 1: p + agg
    ref = mp.pack_dense(u, torch.ones(K, dtype=torch.bool), eng.byz_mask, agg,
                        eng.client_chunks, eng.chunk_size)
    for name in mp.MetricPack._fields:
        torch.testing.assert_close(getattr(packs[0], name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6)
    eng2 = _setup()[2]
    eng2.round_metrics = False
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA), S, B)
    eng2.run_round(eng2.init(w0), cx, cy, 0.1, 1.0, SEED)
    assert eng2.last_metric_pack is None


def test_jax_pack_on_the_port_round_matrix():
    """The pack of a port round equals the JAX package's pack of the same
    matrix, mask and applied aggregate."""
    ds, w0, eng = _setup()
    st, packs = _rounds(ds, w0, eng, rounds=1)
    u = eng.last_updates.numpy()
    agg = (st.params["w"] - w0["w"]).reshape(-1).numpy()
    want = jax_mp.pack_dense(jnp.asarray(u), jnp.ones(K, bool), jnp.asarray(eng.byz_mask.numpy()),
                             jnp.asarray(agg), eng.client_chunks, eng.chunk_size)
    _assert_pack(packs[0], jax.device_get(want))
