"""Trimmed mean in the PyTorch port against the JAX package's kernel.

Every input is drawn with seeded numpy and handed to both packages. The JAX
side runs as its own tests run it on the CPU: the Pallas kernel in interpret
mode (``trimmed_mean(..., interpret=True)``), its plain-XLA extraction
(``_trimmed_mean_extract``), or its dispatcher for b = 0 and the sort path.
Tolerance: f32 ``rtol=atol=1e-5``, the bar the JAX package holds between its
own three lowerings (``tests/test_pallas_trimmed.py``); only the summation
order differs.

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
