"""The in-round forensics on the card against the same functions on the CPU
(slice 10a): the four defenses' diagnostics, the audit monitor (dense,
masked, streaming) and the metric pack, on seeded matrices copied to both.
Integers exactly (trim counts on ALIE-style ties and -0.0 included, Krum's
selection on untied rows), floats at f32 ``rtol = atol = 1e-5``. Every case
needs the card and carries the ``cuda`` marker; the file imports nothing of
JAX, so on the card it runs as ``python -m pytest --noconftest
tests/test_torch_forensics_cuda.py``.
"""

import numpy as np
import pytest
import torch

from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.audit import AuditMonitor
from blades_tpu_torch.ops.streaming import chunk_layout
from blades_tpu_torch.telemetry.metric_pack import _EDGES, MetricPack, edges, pack_dense
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the forensics are compared card against CPU")
    return torch.device("cuda")


def _matrix(seed, k, d, ties=0):
    r = np.random.RandomState(seed)
    u = (r.randn(k, d) * r.uniform(0.2, 2.0, (k, 1))).astype(np.float32)
    if ties:
        u[:ties] = u[0]
    u[ties, :7] = 0.0
    u[ties + 1, :7] = -0.0
    return torch.from_numpy(u)


def _same_fields(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for name in ref:
        a, b = got[name].cpu(), ref[name]
        if b.is_floating_point():
            torch.testing.assert_close(a, b, msg=name, **TOL)
        else:
            assert torch.equal(a, b), name


CASES = [("trimmedmean", {"num_byzantine": 5}), ("krum", {"num_byzantine": 3}),
         ("multikrum", {"num_byzantine": 3, "num_selected": 5}),
         ("centeredclipping", {"tau": 1.0}), ("fltrust", {})]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_diagnostics_card_equals_cpu(card, case, masked):
    name, kw = case
    k, d = 64, 3001
    u = _matrix(1, k, d, ties=0 if name in ("krum", "multikrum") else 6)
    agg = get_aggregator(name, **kw)
    state = agg.init_state(k, d)
    if name == "centeredclipping":
        state = torch.from_numpy(np.random.RandomState(2).randn(d).astype(np.float32) * 0.1)
    ctx = {}
    if name == "fltrust":
        ctx["trusted_mask"] = torch.arange(k) == 9
    mask = None
    if masked:
        mask = torch.ones(k, dtype=torch.bool)
        mask[[3, 40]] = False
        u[[3, 40]] = float("nan")
    on = lambda t: None if t is None else (t.to(card) if isinstance(t, torch.Tensor) else t)  # noqa: E731
    _, _, ref = agg.aggregate_masked_with_diagnostics(u, state, mask=mask, **ctx)
    _, _, got = agg.aggregate_masked_with_diagnostics(
        on(u), on(state), mask=on(mask), **{n: on(v) for n, v in ctx.items()})
    _same_fields(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,b", [(1000, 20_000, 5), (13, 257, 6), (200, 4097, 16)])
def test_trim_counts_card_equals_cpu_on_ties(card, k, d, b):
    """ALIE's f identical rows tie every column: the card's stable sort
    gives the CPU's ranks, so the counts are equal exactly."""
    u = _matrix(3, k, d, ties=min(k // 3, 8))
    agg = get_aggregator("trimmedmean", num_byzantine=b)
    got = agg.diagnostics(u.to(card))
    ref = agg.diagnostics(u)
    assert torch.equal(got["trim_counts"].cpu(), ref["trim_counts"])
    assert int(ref["trim_counts"].sum()) == 2 * agg._effective_b(k) * d


MONITOR_MASKS = {"none": None, "two-off": (5, 17), "nan-off": (8,)}


@pytest.mark.cuda
@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("mask", sorted(MONITOR_MASKS))
def test_audit_card_equals_cpu(card, mask, far):
    k, d = 200, 5003
    u = _matrix(4, k, d, ties=5)
    m = None
    if MONITOR_MASKS[mask] is not None:
        m = torch.ones(k, dtype=torch.bool)
        m[list(MONITOR_MASKS[mask])] = False
        if mask == "nan-off":
            u[list(MONITOR_MASKS[mask])] = float("nan")
    agg = torch.full((d,), 5.0 if far else 0.01)
    byz = torch.arange(k) < 5
    mon = AuditMonitor(fallback_aggregator="trimmedmean")
    ref_final, ref = mon.apply(u, agg, mask=m, byz_mask=byz)
    got_final, got = mon.apply(u.to(card), agg.to(card), mask=None if m is None else m.to(card),
                               byz_mask=byz.to(card))
    _same_fields(got, ref)
    torch.testing.assert_close(got_final.cpu(), ref_final, **TOL)
    assert int(got["breach"]) == int(far)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 4])
def test_streaming_audit_card_equals_cpu(card, chunks):
    k, d = 100, 2001
    u = _matrix(5, k, d, ties=4)
    agg = torch.zeros(d)
    mon = AuditMonitor()
    c, cs, pad = chunk_layout(k, chunks)
    out = []
    for dev in (torch.device("cpu"), card):
        up = torch.cat([u, u.new_zeros(pad, d)]).to(dev)
        mask = torch.arange(c * cs, device=dev) < k
        st = mon.streaming_init(k, c, cs, d, device=dev)
        for j in range(c):
            rows = slice(j * cs, (j + 1) * cs)
            st = mon.streaming_update(st, up[rows], chunk_mask=mask[rows], chunk_index=j)
        out.append(mon.streaming_apply(st, agg.to(dev))[1])
    # the diameter bounds read the chunk medians' Gram matrix, whose
    # diagonal is f32 cancellation (tests/test_torch_audit.py): held to
    # 2 sqrt(8 eps |c|^2), |c|^2 bounded by the sum of each column's largest
    # square (a median's coordinate is one of its column's values)
    gram = ("diameter", "diameter_lo")
    ref, got = ({n: v for n, v in o.items() if n not in gram} for o in out)
    _same_fields(got, ref)
    c2 = float((u * u).max(dim=0).values.sum())
    bound = 2 * (8 * torch.finfo(torch.float32).eps * c2) ** 0.5
    for name in gram:
        torch.testing.assert_close(out[1][name].cpu(), out[0][name], rtol=TOL["rtol"],
                                   atol=bound, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("off", [(), (2, 9, 33)], ids=["all", "three-off"])
def test_metric_pack_card_equals_cpu(card, off):
    k, d, chunks = 120, 7001, 4
    u = _matrix(6, k, d, ties=5) * torch.logspace(-6, 3, k)[:, None]
    mask = torch.ones(k, dtype=torch.bool)
    mask[list(off)] = False
    byz = torch.arange(k) < 5
    agg = torch.from_numpy(np.random.RandomState(7).randn(d).astype(np.float32))
    c, cs, _ = chunk_layout(k, chunks)
    ref = pack_dense(u, mask, byz, agg, c, cs)
    got = pack_dense(u.to(card), mask.to(card), byz.to(card), agg.to(card), c, cs)
    _same_fields(got._asdict(), ref._asdict())
    assert isinstance(got, MetricPack)
    # the bin edges made on the card are the JAX package's float32 edges
    assert torch.equal(edges(card).cpu(), torch.tensor(_EDGES, dtype=torch.float32))
