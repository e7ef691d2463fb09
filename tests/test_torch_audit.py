"""The runtime audit monitor (``audit/monitor.py``) against the JAX
package's.

``certify`` and ``apply`` dense and masked (NaN rows masked out), the
streaming forms chunk by chunk, a forced breach that takes the fallback,
and a round with no participant, on numpy-seeded inputs handed to both
packages: flags and counts exactly, floats at f32 ``rtol = atol = 1e-5``.
Then the monitor inside the port's dense, streaming and async rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.audit import AuditMonitor as JaxAuditMonitor
from blades_tpu.audit import CERTIFICATE_NAMES as JAX_CERTIFICATE_NAMES
from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers.base import Attack
from blades_tpu_torch.audit import CERTIFICATE_NAMES, AuditMonitor
from blades_tpu_torch.ops.streaming import chunk_layout
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
K, D = 12, 41


def _inputs(seed, off=(), nan_off=False, k=K, d=D):
    r = np.random.RandomState(seed)
    u = r.randn(k, d).astype(np.float32)
    u[:3] = u[0] + 0.5  # a byzantine cluster, ALIE-style
    m = np.ones(k, bool)
    m[list(off)] = False
    if nan_off:
        u[list(off)] = np.nan
    byz = np.arange(k) < 3
    return u, m, byz


def _assert_diag(got, want, atol=None):
    """Every field: integers exactly, floats at TOL, or at ``atol[name]``
    where one is given."""
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        mine = got[name].numpy()
        assert mine.shape == ref.shape, name
        if ref.dtype.kind in "biu":
            assert mine.dtype.kind in "biu", name
            np.testing.assert_array_equal(mine, ref, err_msg=name)
        else:
            tol = dict(TOL, atol=max(TOL["atol"], (atol or {}).get(name, 0.0)))
            np.testing.assert_allclose(mine, ref, err_msg=name, **tol)


def _gram_atol(u, m, chunks):
    """The streaming diameter bounds read the chunk medians' ``[C, C]``
    distances from their Gram matrix, ``|a|^2 + |b|^2 - 2 a.b``: on the
    diagonal (a chunk against itself) that is 0 in exact arithmetic and the
    rounding of ``2 |c|^2`` in f32, under a square root. Each package gets
    its own such value; both lie within ``sqrt(8 eps max|c|^2)`` of the
    exact one, and are held to that."""
    k = u.shape[0]
    c, cs, pad = chunk_layout(k, chunks)
    up, mp = np.pad(u, ((0, pad), (0, 0))), np.pad(m, (0, pad))
    sq = [float(np.sum(np.median(up[j * cs:(j + 1) * cs][mp[j * cs:(j + 1) * cs]], 0) ** 2))
          for j in range(c) if mp[j * cs:(j + 1) * cs].any()]
    bound = float(np.sqrt(8 * np.finfo(np.float32).eps * max(sq + [0.0]))) * 2
    return {"diameter": bound, "diameter_lo": bound}


MONITORS = {
    "default": {},
    "median-ball-only": {"certificates": ("median_ball",), "median_ball_factor": 0.5},
    "envelope-tight": {"certificates": ("envelope",), "envelope_factor": 0.2},
    "fallback-median": {"fallback_aggregator": "median"},
    "fallback-trimmedmean": {"fallback_aggregator": "trimmedmean"},
}
MASKS = {"none": None, "two-off": (4, 9), "nan-off": (5,)}


def test_certificate_names_match_jax():
    assert CERTIFICATE_NAMES == JAX_CERTIFICATE_NAMES
    assert repr(AuditMonitor(fallback_aggregator="median")).startswith("AuditMonitor(")


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("monitor", sorted(MONITORS))
def test_certify_and_apply_match_jax(monitor, mask):
    off = MASKS[mask]
    u, m, byz = _inputs(1, off=off or (), nan_off=mask == "nan-off")
    agg = np.random.RandomState(2).randn(D).astype(np.float32) * 0.3
    ours, ref = AuditMonitor(**MONITORS[monitor]), JaxAuditMonitor(**MONITORS[monitor])
    tm = None if off is None else torch.tensor(m)
    jm = None if off is None else jnp.asarray(m)
    breach, diag = ours.certify(torch.tensor(u), torch.tensor(agg), tm)
    jbreach, jdiag = ref.certify(jnp.asarray(u), jnp.asarray(agg), jm)
    assert bool(breach) == bool(jbreach)
    _assert_diag(diag, jdiag)
    final, adiag = ours.apply(torch.tensor(u), torch.tensor(agg), mask=tm,
                              byz_mask=torch.tensor(byz))
    jfinal, jadiag = ref.apply(jnp.asarray(u), jnp.asarray(agg), mask=jm,
                               byz_mask=jnp.asarray(byz))
    _assert_diag(adiag, jadiag)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)
    assert bool(torch.isfinite(final).all())


@pytest.mark.parametrize("fallback", ["median", "trimmedmean"])
def test_forced_breach_takes_the_fallback(fallback):
    """An aggregate far outside the delivered cloud breaches both
    certificates; the round applies the fallback's aggregate instead."""
    u, m, byz = _inputs(3)
    agg = np.full(D, 50.0, np.float32)
    ours = AuditMonitor(fallback_aggregator=fallback)
    ref = JaxAuditMonitor(fallback_aggregator=fallback)
    final, diag = ours.apply(torch.tensor(u), torch.tensor(agg), byz_mask=torch.tensor(byz))
    jfinal, jdiag = ref.apply(jnp.asarray(u), jnp.asarray(agg), byz_mask=jnp.asarray(byz))
    assert int(diag["breach"]) == int(diag["fallback_used"]) == 1
    assert int(diag["cert_median_ball"]) == int(diag["cert_envelope"]) == 0
    _assert_diag(diag, jdiag)
    fb, _ = get_aggregator(fallback).aggregate(torch.tensor(u))
    assert torch.equal(final, fb)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)
    # the raw deviation keeps the breached aggregate's
    assert float(diag["dev_honest_raw"]) > float(diag["dev_honest"])


def test_breach_without_fallback_keeps_the_aggregate():
    u, _, byz = _inputs(4)
    agg = torch.full((D,), 50.0)
    final, diag = AuditMonitor().apply(torch.tensor(u), agg, byz_mask=torch.tensor(byz))
    assert int(diag["breach"]) == 1 and int(diag["fallback_used"]) == 0
    assert torch.equal(final, agg)


def test_zero_participants_never_breach():
    u, m, byz = _inputs(5, off=tuple(range(K)), nan_off=True)
    agg = np.zeros(D, np.float32)
    ours = AuditMonitor(fallback_aggregator="median")
    ref = JaxAuditMonitor(fallback_aggregator="median")
    final, diag = ours.apply(torch.tensor(u), torch.tensor(agg), mask=torch.tensor(m),
                             byz_mask=torch.tensor(byz))
    jfinal, jdiag = ref.apply(jnp.asarray(u), jnp.asarray(agg), mask=jnp.asarray(m),
                              byz_mask=jnp.asarray(byz))
    _assert_diag(diag, jdiag)
    assert int(diag["participants"]) == 0 and int(diag["breach"]) == 0
    assert int(diag["honest_participants"]) == 0 and float(diag["dev_honest"]) == 0.0
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)


def test_stateful_fallback_and_unknown_certificate_raise():
    with pytest.raises(ValueError, match="stateful"):
        AuditMonitor(fallback_aggregator="centeredclipping")
    with pytest.raises(ValueError, match="unknown certificate"):
        AuditMonitor(certificates=("nope",))
    with pytest.raises(ValueError, match="at least one"):
        AuditMonitor(certificates=())


def _streaming(monitor, u, m, chunks, agg, fallback_agg=None, jax=False):
    k, d = u.shape
    c, cs, pad = chunk_layout(k, chunks)
    up, mp = np.pad(u, ((0, pad), (0, 0))), np.pad(m, (0, pad))
    arr = (lambda a: jnp.asarray(a)) if jax else (lambda a: torch.tensor(a))
    st = monitor.streaming_init(k, c, cs, d)
    for j in range(c):
        rows = slice(j * cs, (j + 1) * cs)
        mask = mp[rows]
        safe = np.where(mask[:, None], up[rows], 0.0).astype(np.float32)
        idx = jnp.asarray(j, jnp.int32) if jax else j
        st = monitor.streaming_update(st, arr(safe), chunk_mask=arr(mask), chunk_index=idx)
    fb = None if fallback_agg is None else arr(fallback_agg)
    return monitor.streaming_apply(st, arr(agg), fallback_agg=fb)


@pytest.mark.parametrize("chunks", [1, 3, 4, K])
@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
def test_streaming_certificates_match_jax(far, mask, chunks):
    off = MASKS[mask]
    u, m, _ = _inputs(6, off=off or (), nan_off=mask == "nan-off")
    agg = np.full(D, 50.0 if far else 0.05, np.float32)
    fb = np.zeros(D, np.float32)
    ours = AuditMonitor(fallback_aggregator="median")
    ref = JaxAuditMonitor(fallback_aggregator="median")
    final, diag = _streaming(ours, u, m, chunks, agg, fb)
    jfinal, jdiag = _streaming(ref, u, m, chunks, agg, fb, jax=True)
    _assert_diag(diag, jdiag, atol=_gram_atol(u, m, chunks))
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **TOL)
    assert int(diag["breach"]) == int(far)


def test_singleton_chunks_equal_the_dense_certificates():
    """One row a chunk: every streaming interval is a point, and the
    verdicts and bounds are the dense certificates'."""
    u, m, _ = _inputs(7, off=(2,))
    agg = np.random.RandomState(0).randn(D).astype(np.float32) * 0.2
    mon = AuditMonitor()
    _, sdiag = _streaming(mon, u, m, K, agg)
    _, ddiag = mon.certify(torch.tensor(u), torch.tensor(agg), torch.tensor(m))
    for name in ("cert_median_ball", "cert_envelope", "participants"):
        assert int(sdiag[name]) == int(ddiag[name]), name
    for name in ("dev_median", "spread_median", "diameter"):
        torch.testing.assert_close(sdiag[name], ddiag[name], rtol=1e-5, atol=1e-5)


# -- the monitor inside the port's rounds ------------------------------------

def _sim(tmp_path, name, **ds_kw):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    return Simulator(Synthetic(num_clients=8, train_size=200, test_size=40, cache=False),
                     attack="signflipping", num_byzantine=2, aggregator="trimmedmean",
                     aggregator_kws={"num_byzantine": 2}, device="cpu",
                     log_path=str(tmp_path / name))


@pytest.mark.parametrize("mode", ["dense", "streaming", "async"])
def test_monitor_runs_in_every_round_kind(tmp_path, mode):
    """The dense round audits the matrix the defense consumed, the streaming
    round its chunk summaries, the async tick its weighted buffer (a tick
    that does not fire never breaches)."""
    kw = {"dense": {}, "streaming": {"streaming": True, "client_chunks": 3},
          "async": {"async_config": {"buffer_m": 5, "arrivals": {"kind": "uniform",
                                                                  "max_delay": 2}}}}[mode]
    sim = _sim(tmp_path, mode)
    monitor = AuditMonitor(median_ball_factor=0.01, fallback_aggregator="median")
    seen = []

    def on_round_end(rnd, state, m):
        seen.append({n: v.clone() for n, v in sim.engine.last_audit_diag.items()})

    run = dict(model="mlp", global_rounds=3, train_batch_size=4, audit_monitor=monitor,
               round_metrics=True, **kw)
    if mode != "streaming":
        run["on_round_end"] = on_round_end
    sim.run(**run)
    diag = sim.engine.last_audit_diag
    assert diag is not None and "breach" in diag and "agg_norm" in diag
    assert ("spread_median_lo" in diag) == (mode == "streaming")
    assert ("dev_honest" in diag) == (mode != "streaming")
    if mode == "async":
        fired = sim.engine.last_async_diag["fired"]
        assert int(diag["breach"]) <= int(fired)
    for d in seen:
        # a factor of 0.01 breaches whenever the round applied anything
        assert int(d["fallback_used"]) == int(d["breach"])


# -- the fallback's draws and its graph safety -----------------------------------

C2_K, C2_D = 20, 400


class _FixedMatrix(Attack):
    """An attack that replaces the round's matrix with a seeded normal one."""

    def __init__(self, u):
        self.u = u

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        return self.u.to(updates.device), state


def _recorded(agg, out):
    """Shadow ``agg.aggregate_masked`` on the instance to keep each result."""
    real = agg.aggregate_masked

    def wrapped(*args, **kw):
        res = real(*args, **kw)
        out.append(res[0].clone())
        return res

    agg.aggregate_masked = wrapped
    return agg


def _dnc_engine(primary, monitor, async_config=None):
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.ops.pytree import FlatLayout, LeafSpec

    def loss_fn(p, x, y, noise=None):
        loss = (p["w"] * x).sum(-1).mean()
        return loss, {"top1": loss * 0}

    u = torch.from_numpy(np.random.RandomState(7).randn(C2_K, C2_D).astype(np.float32))
    layout = FlatLayout((LeafSpec("w", ("w",), (C2_D,)),))
    return RoundEngine(loss_fn, lambda p, x: x, {"w": torch.zeros(C2_D)}, layout,
                       num_clients=C2_K, num_byzantine=4, attack=_FixedMatrix(u),
                       aggregator=primary, device="cpu", audit_monitor=monitor,
                       async_config=async_config), u


@pytest.mark.parametrize("mode", ["dense", "async-static", "async"])
def test_fallback_draws_what_the_primary_drew(mode):
    """A random fallback (DnC) gets the ``AGG`` stream at its entry state, as
    the JAX package hands the defense and the fallback one key: with the same
    DnC as both, the fallback's aggregate equals the primary's bit for bit
    (a generator shared between the two gave aggregates up to 0.83 apart).
    Through the dense round and the async tick (zero delays: the sync
    round's unmasked calls; delays: the masked ones)."""
    from blades_tpu.aggregators.dnc import Dnc as JaxDnc
    from blades_tpu_torch.aggregators.dnc import Dnc
    from blades_tpu_torch.asyncfl import AsyncConfig

    prim, fall = [], []
    monitor = AuditMonitor(median_ball_factor=0.0, certificates=("median_ball",),
                           fallback_aggregator=_recorded(Dnc(sub_dim=20, num_iters=2), fall))
    cfg = {"dense": None,
           "async-static": AsyncConfig(buffer_m=C2_K),
           "async": AsyncConfig(buffer_m=3, arrivals={"kind": "uniform", "max_delay": 1})}[mode]
    eng, u = _dnc_engine(_recorded(Dnc(sub_dim=20, num_iters=2), prim), monitor, cfg)
    state = eng.init({"w": torch.zeros(C2_D)})
    r = np.random.RandomState(0)
    for rnd in range(3):
        cx = torch.from_numpy(r.randn(C2_K, 1, 2, C2_D).astype(np.float32))
        cy = torch.zeros(C2_K, 1, 2, dtype=torch.int64)
        state, _ = eng.run_round(state, cx, cy, 0.1, 1.0, seed=rnd)
        assert int(eng.last_audit_diag["breach"]) == int(
            1 if mode != "async" else eng.last_async_diag["fired"])
    assert len(prim) == len(fall) == 3
    for a, b in zip(prim, fall):
        assert torch.equal(a, b)
    assert not torch.equal(prim[0], u.mean(0))  # DnC removed rows
    # the JAX package: one key for both, so the same aggregate
    jdnc, key = JaxDnc(sub_dim=20, num_iters=2), jax.random.PRNGKey(3)
    jagg, _ = jdnc.aggregate(jnp.asarray(u.numpy()), (), key=key)
    jfinal, jdiag = JaxAuditMonitor(median_ball_factor=0.0, certificates=("median_ball",),
                                    fallback_aggregator=jdnc).apply(
        jnp.asarray(u.numpy()), jagg, key=key)
    assert int(jdiag["fallback_used"]) == 1
    np.testing.assert_array_equal(np.asarray(jfinal), np.asarray(jagg))


def test_graph_block_reason_checks_the_fallback():
    """A fallback whose loop tests its stopping rule on the host (GeoMed,
    AutoGM) runs every round, so the block runs eagerly and names it; a
    graph-safe fallback keeps the graph. Decided as on the card (an engine
    whose device is ``cuda``)."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.aggregators.dnc import Dnc

    eng, _ = _dnc_engine(get_aggregator("median"), AuditMonitor(fallback_aggregator="geomed"))
    eng.device = torch.device("cuda")
    assert eng.graph_block_reason().startswith("Geomed: its Weiszfeld loop")
    eng.audit_monitor = AuditMonitor(fallback_aggregator="autogm")
    assert eng.graph_block_reason().startswith("Autogm: its outer and Weiszfeld loops")
    for fb in ("trimmedmean", "median", Dnc(sub_dim=20), None):
        eng.audit_monitor = AuditMonitor(fallback_aggregator=fb)
        assert eng.graph_block_reason() is None
    eng.audit_monitor = None
    assert eng.graph_block_reason() is None


@pytest.mark.cuda
def test_geomed_fallback_block_runs_eagerly_on_the_card(tmp_path):
    """``run(block_size=2)`` with a GeoMed fallback runs its block eagerly
    on the card and names why; a capture would raise at its host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph decision is the card's")
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    sim = Simulator(Synthetic(num_clients=8, train_size=200, test_size=40, cache=False),
                    attack="alie", num_byzantine=2, aggregator="median", device="cuda",
                    log_path=str(tmp_path / "out"))
    sim.run(model="mlp", global_rounds=2, block_size=2, train_batch_size=4,
            audit_monitor=AuditMonitor(fallback_aggregator="geomed"))
    assert sim.engine.last_block_mode == "eager"
    assert sim.engine.last_block_reason.startswith("Geomed: its Weiszfeld loop")
