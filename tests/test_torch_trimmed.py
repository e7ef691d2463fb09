"""Trimmed mean in the PyTorch port against the JAX package's kernel.

Every input is drawn with seeded numpy and handed to both packages. The JAX
side runs as its own tests run it on the CPU: the Pallas kernel in interpret
mode (``trimmed_mean(..., interpret=True)``), its plain-XLA extraction
(``_trimmed_mean_extract``), or its dispatcher for b = 0 and the sort path.
Tolerance: f32 ``rtol=atol=1e-5``, the bar the JAX package holds between its
own three lowerings (``tests/test_pallas_trimmed.py``); only the summation
order differs.

The Hopper kernel cannot run on the CPU, so :func:`_model_trimmed_mean`
models its selection in numpy, step for step (lane extremes, a warp
threshold, gathered candidates ranked against each other, the general
route of bisection and tie scan, lane partial sums), and is held to the
plain version and to the JAX package for every b.

The JAX package is imported inside a fixture so this file also runs where
only the port is installed (the GPU machine, ``--noconftest``): there the
parity cases skip and the ``cuda`` cases run the Hopper kernel.
"""

import numpy as np
import pytest
import torch

from blades_tpu_torch.ops import trimmed
from blades_tpu_torch.ops.trimmed import (
    MAX_KERNEL_B,
    trimmed_mean,
    trimmed_mean_cuda,
    trimmed_mean_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_tm():
    """The JAX package's trimmed-mean module (the reference)."""
    return pytest.importorskip("blades_tpu.ops.pallas_trimmed")


def _randn(k, d, seed, scale=10.0):
    return (np.random.RandomState(seed).randn(k, d) * scale).astype(np.float32)


def _ties():
    # test_pallas_trimmed.py:34-35: duplicated extrema
    return np.array([[5.0, 1.0], [5.0, 1.0], [0.0, 1.0], [-5.0, 0.0],
                     [-5.0, 0.0], [2.0, 0.5]], np.float32)


def _extremes(k, d, seed):
    u = np.random.RandomState(seed).randn(k, d).astype(np.float32)
    u[0], u[1], u[2] = 1e30, -3e38, 3e38  # a column sum would overflow f32
    return u


def _all_equal_column():
    u = _randn(12, 5, 8)
    u[:, 2] = 0.75
    return u


def _alie_ties(k=20, d=300, f=6):
    # ALIE writes the same row for every byzantine client
    u = _randn(k, d, 9, scale=0.01)
    u[:f] = u[0]
    return u


# -- a model of the kernel's selection (csrc/trimmed_mean.cu) ----------------

_INF = np.float32(np.inf)


def _order_key(v):
    u = int(np.float32(v).view(np.uint32))
    return (~u) & 0xFFFFFFFF if u & 0x80000000 else u | 0x80000000


def _key_value(k):
    u = k & 0x7FFFFFFF if k & 0x80000000 else (~k) & 0xFFFFFFFF
    return np.uint32(u).view(np.float32)


def _model_select(x, eligible, b, thr, top):
    """The kernel's general route: (value, row) of the b-th eligible entry
    of column x under (value desc, row asc) if top, else (value asc, row
    asc), given a threshold with at least b eligible entries at or beyond
    it. Bisect the ordered keys for the value, then scan its ties."""

    def count(k):  # one count pass
        probe = _key_value(k)
        return int((eligible & ((x >= probe) if top else (x <= probe))).sum())

    # the first probe asks whether thr itself is the value
    if top:
        lo, hi, edge = _order_key(thr), _order_key(_INF), 0
        mid = lo + 1
    else:
        lo, hi, edge = _order_key(-_INF), _order_key(thr), 0
        mid = hi - 1
    while hi - lo > 1:
        c = count(mid)
        if (c >= b) == top:
            lo = mid
        else:
            hi = mid
        if c < b:
            edge = c
        mid = lo + (hi - lo) // 2
    value = _key_value(lo if top else hi)
    ties = np.flatnonzero(eligible & (x == value))  # tie scan in row order
    return value, int(ties[b - edge - 1])


def _first_b(v, b, top):
    """Indices of the first b of list v under (value, index) order."""
    order = sorted(range(len(v)), key=lambda i: ((-v[i]) if top else v[i], i))
    return order[:b]


def _model_trimmed_mean(u, b, lanes=32, cap=32, general=False):
    """The kernel's trimmed mean with `lanes` lanes a column and lists of
    `cap` entries: lane l holds rows l, l + lanes, ...; theta (the b-th
    largest lane max) and theta' (the b-th smallest lane min) gather the top
    and bottom lists in row order; an overflowing list takes the b-th of the
    entries it kept as its threshold, or gathers strictly beyond it when
    that is no higher; with the lists disjoint, T is the top list's first b
    and S the bottom list's, and every entry in neither list survives.
    Otherwise (or with ``general``) the general route. Lane partial sums,
    then their sum over K - 2b."""
    u = np.asarray(u, np.float32)
    k, d = u.shape
    rows = np.arange(k)
    lane = rows % lanes
    out = np.empty(d, np.float32)
    for c in range(d):
        x = u[:, c]
        lmax = np.full(lanes, -_INF, np.float32)
        lmin = np.full(lanes, _INF, np.float32)
        lrow = np.full(lanes, -1)
        for r in range(k):  # in row order: the last of equal minima stays
            lmax[lane[r]] = max(lmax[lane[r]], x[r])
            if x[r] <= lmin[lane[r]]:
                lmin[lane[r]], lrow[lane[r]] = x[r], r
        thr_t = np.sort(lmax)[::-1][b - 1]
        thr_b = np.sort(lmin)[b - 1]
        strict_t = strict_b = False
        while not general:
            if not (thr_b < thr_t or (thr_b == thr_t and (strict_t or strict_b))):
                general = True  # the lists would overlap
                break
            top = np.flatnonzero((x > thr_t) if strict_t else (x >= thr_t))  # row order
            bot = np.flatnonzero((x < thr_b) if strict_b else (x <= thr_b))
            again = False
            if len(top) > cap:  # the b-th of the kept entries, else strictly beyond
                th = np.sort(x[top[:cap]])[::-1][b - 1]
                strict_t, thr_t, again = not th > thr_t, th, True
            elif len(top) < b:
                general = True
            if len(bot) > cap:
                th = np.sort(x[bot[:cap]])[b - 1]
                strict_b, thr_b, again = not th < thr_b, th, True
            elif len(bot) < b:
                general = True
            if general or not again:
                break
        keep = np.ones(k, bool)
        if not general:
            keep[top[_first_b(x[top], b, True)]] = False
            keep[bot[_first_b(x[bot], b, False)]] = False
        else:
            tval, trow = _model_select(x, np.ones(k, bool), b, thr_t, True)
            in_top = (x > tval) | ((x == tval) & (rows <= trow))
            lmin_in_top = (lmin > tval) | ((lmin == tval) & (lrow <= trow))
            thr_g = np.sort(np.where(lmin_in_top, _INF, lmin))[b - 1]
            sval, srow = _model_select(x, ~in_top, b, thr_g, False)
            in_bottom = ~in_top & ((x < sval) | ((x == sval) & (rows <= srow)))
            keep = ~in_top & ~in_bottom
        assert keep.sum() == k - 2 * b
        part = np.array([x[keep & (lane == l)].sum(dtype=np.float32) for l in range(lanes)],
                        np.float32)
        out[c] = part.sum(dtype=np.float32) / np.float32(k - 2 * b)
    return out


def _lane_ordered(k, d, seed):
    # every lane's rows above the next lane's: the gathered list overflows
    # and the kernel takes the general route
    base = (np.arange(k) % 32) * 100.0 + np.arange(k) // 32
    return (base[:, None] + np.random.RandomState(seed).rand(1, d)).astype(np.float32)


def _model_matrix(kind, b):
    """A matrix for the model tests at this b; K is never a multiple of 32
    or of 19, the model's two lane counts."""
    rs = np.random.RandomState(100 + b)
    if kind == "ties":
        return np.round(rs.randn(3 * b + 5, 7) * 2).astype(np.float32) / 2
    if kind == "all_equal":
        u = rs.randn(2 * b + 1, 5).astype(np.float32)
        u[:, 1], u[:, 3] = 0.75, 0.0
        u[::2, 4] = -0.0  # -0.0 and 0.0 compare equal: one tie class
        u[1::2, 4] = 0.0
        return u
    if kind == "alie":
        u = (rs.randn(4 * b + 3, 6) * 0.01).astype(np.float32)
        u[: b + 1] = u[0]
        return u
    if kind == "extremes":
        u = rs.randn(2 * b + 9, 5).astype(np.float32)
        u[0], u[1], u[2] = 1e30, -3e38, 3e38
        return u
    if kind == "lane_ordered":
        return _lane_ordered(70 + b, 3, b)
    raise ValueError(kind)


# every case of tests/test_pallas_trimmed.py (matrix, b, how the JAX side runs)
CASES = {
    "kernel-10x257-b2": (lambda: _randn(10, 257, 0), 2, "interpret"),
    "kernel-32x1000-b5": (lambda: _randn(32, 1000, 0), 5, "interpret"),
    "kernel-9x64-b1": (lambda: _randn(9, 64, 0), 1, "interpret"),
    "kernel-ties-b2": (_ties, 2, "interpret"),
    "kernel-extremes-b3": (lambda: _extremes(10, 65, 4), 3, "interpret"),
    "b0-mean": (lambda: _randn(7, 33, 1, scale=1.0), 0, "dispatch"),
    "extract-10x257-b2": (lambda: _randn(10, 257, 3), 2, "extract"),
    "extract-32x1000-b5": (lambda: _randn(32, 1000, 3), 5, "extract"),
    "extract-6x2-b2": (lambda: _randn(6, 2, 3), 2, "extract"),
    "extract-ties-b2": (_ties, 2, "extract"),
    "extract-extremes-b3": (lambda: _extremes(10, 33, 5), 3, "extract"),
    "sort-48x64-b17": (lambda: _randn(48, 64, 2, scale=1.0), MAX_KERNEL_B + 1, "dispatch"),
    "all-equal-column-b3": (_all_equal_column, 3, "interpret"),
    "alie-ties-b6": (_alie_ties, 6, "interpret"),
}


def _jax_reference(jax_tm, u, b, how):
    import jax.numpy as jnp

    if how == "interpret":
        return np.asarray(jax_tm.trimmed_mean(jnp.asarray(u), b, interpret=True))
    if how == "extract":
        return np.asarray(jax_tm._trimmed_mean_extract(jnp.asarray(u), b))
    return np.asarray(jax_tm.trimmed_mean(jnp.asarray(u), b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax(jax_tm, case):
    make, b, how = CASES[case]
    u = make()
    expect = _jax_reference(jax_tm, u, b, how)
    got = trimmed_mean(torch.from_numpy(u), b).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, expect, **TOL)
    if 1 <= b <= MAX_KERNEL_B:
        # on a CPU tensor the dispatcher is the plain version, exactly
        np.testing.assert_array_equal(got, trimmed_mean_plain(torch.from_numpy(u), b).numpy())


def test_all_equal_column_trims_distinct_rows():
    # the tie rule removes rows 0..b-1 as maxima and b..2b-1 as minima, so a
    # constant column averages to its value exactly
    u = _all_equal_column()
    assert trimmed_mean_plain(torch.from_numpy(u), 3)[2].item() == pytest.approx(0.75, abs=0)


@pytest.mark.parametrize("k,b", [(10, 5), (10, 0), (40, MAX_KERNEL_B + 1), (3, -1)])
def test_kernel_wrapper_rejects_bad_b(k, b):
    with pytest.raises(ValueError, match="2b < K"):
        trimmed_mean_cuda(torch.zeros(k, 8), b)


def test_kernel_wrapper_rejects_cpu_tensor():
    # a CPU tensor never reaches the kernel, and the wrapper does not quietly
    # compute the plain version either
    with pytest.raises(ValueError, match="CUDA tensor"):
        trimmed_mean_cuda(torch.zeros(10, 8), 2)


def test_kernel_wrapper_rejects_dtype_and_layout():
    with pytest.raises(TypeError, match="float32"):
        trimmed_mean_cuda(torch.zeros(10, 8, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="contiguous"):
        trimmed_mean_cuda(torch.zeros(8, 10).t(), 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    ["kernel-10x257-b2", "kernel-32x1000-b5", "kernel-ties-b2", "kernel-extremes-b3",
     "extract-6x2-b2", "all-equal-column-b3", "alie-ties-b6"],
)
def test_cuda_kernel_matches_plain(cuda_device, case):
    make, b, _ = CASES[case]
    x = torch.from_numpy(make()).to(cuda_device)
    before = trimmed.trimmed_mean_launches
    got = trimmed_mean(x, b)
    torch.cuda.synchronize()
    assert trimmed.trimmed_mean_launches == before + 1
    np.testing.assert_allclose(
        got.cpu().numpy(), trimmed_mean_plain(x, b).cpu().numpy(), **TOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize("b", range(1, MAX_KERNEL_B + 1))
def test_cuda_kernel_every_b(cuda_device, b):
    x = torch.from_numpy(_randn(2 * b + 7, 1000, b)).to(cuda_device)
    x[: b + 1] = x[0]  # ties across the top and bottom sets
    np.testing.assert_allclose(
        trimmed_mean_cuda(x, b).cpu().numpy(),
        trimmed_mean_plain(x, b).cpu().numpy(),
        **TOL,
    )


@pytest.mark.parametrize("kind", ["ties", "all_equal", "alie", "extremes", "lane_ordered"])
@pytest.mark.parametrize("b", range(1, MAX_KERNEL_B + 1))
def test_selection_model_matches_plain(b, kind):
    # as on the card (32 lanes, 32-entry lists), 19 lanes, lists of b
    # entries that overflow and tighten, and every column down the general
    # route
    u = _model_matrix(kind, b)
    plain = trimmed_mean_plain(torch.from_numpy(u), b).numpy()
    for lanes, cap, general in ((32, 32, False), (19, 32, False), (32, b, False),
                                (32, 32, True)):
        got = _model_trimmed_mean(u, b, lanes=lanes, cap=cap, general=general)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, plain, **TOL,
                                   err_msg=f"lanes={lanes} cap={cap} general={general}")


@pytest.mark.parametrize("kind", ["ties", "all_equal", "alie", "extremes"])
def test_selection_model_matches_jax(jax_tm, kind):
    for b in range(1, MAX_KERNEL_B + 1):
        u = _model_matrix(kind, b)
        expect = _jax_reference(jax_tm, u, b, "extract")
        np.testing.assert_allclose(_model_trimmed_mean(u, b), expect, **TOL, err_msg=f"b={b}")


def _card_matrix(k, d, b, device, seed=0):
    """Seeded normal rows with ALIE-style identical rows 0..b, an all-equal
    column, a column of mixed -0.0 and 0.0, and a lane-ordered column."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(k, d, generator=g, device=device) * 1e-2
    x[: b + 1] = x[0]
    x[:, 0] = 0.75
    if d > 1:
        x[:, 1] = 0.0
        x[::3, 1] = -0.0
    if d > 2:
        x[:, 2] = torch.from_numpy(_lane_ordered(k, 1, seed)[:, 0]).to(device)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,d,b",
    [
        (3, 40, 1), (11, 300, 5), (33, 257, 16),  # K = 2b+1
        (1000, 1001, 5), (1000, 333, 16),  # K and D off the warp and tile widths
        (3297, 70, 8), (3298, 70, 8),  # the last K a tile holds, the first it streams
        (8192, 2049, 5), (8192, 129, 16),  # streamed in chunks
        (1000, 283_723, 5),  # CCT-2's D
    ],
)
def test_cuda_kernel_shapes(cuda_device, k, d, b):
    x = _card_matrix(k, d, b, cuda_device)
    got = trimmed_mean_cuda(x, b)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, trimmed_mean_plain(x, b), **TOL)
