"""ALIE and honest_stats in the port against the JAX package, on the same
seeded-numpy ``[K, D]`` matrix and byzantine mask. Tolerance f32
``rtol=1e-5, atol=1e-6``: masked moments summed in two frameworks' orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.attackers.base import honest_stats as jax_honest_stats
from blades_tpu_torch.attackers import Alie, NoAttack, get_attack, honest_stats

TOL = dict(rtol=1e-5, atol=1e-6)


def _matrix(k=12, d=40, seed=0):
    return (np.random.RandomState(seed).randn(k, d) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n,f", [(10, 4), (1000, 5), (12, 1), (10, 9), (4, 0)])
def test_alie_z_max_matches_jax(n, f):
    assert Alie()._z_max(n, f) == JaxAlie()._z_max(n, f)


@pytest.mark.parametrize("f,explicit", [(4, True), (3, False)])
def test_alie_on_updates_matches_jax(f, explicit):
    u = _matrix()
    mask = np.arange(u.shape[0]) < f
    kws = dict(num_clients=u.shape[0], num_byzantine=f) if explicit else {}
    expect, _ = JaxAlie(**kws).on_updates(jnp.asarray(u), jnp.asarray(mask), None)
    got, state = Alie(**kws).on_updates(torch.from_numpy(u), torch.from_numpy(mask))
    assert state == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    # every byzantine row is the same vector; honest rows are untouched
    np.testing.assert_array_equal(got[:f].numpy(), np.repeat(got[:1].numpy(), f, 0))
    np.testing.assert_array_equal(got[f:].numpy(), u[f:])


@pytest.mark.parametrize("n_honest", [0, 1, 5])
def test_honest_stats_matches_jax(n_honest):
    u = _matrix(k=6)
    mask = np.arange(6) >= n_honest  # the first n_honest rows are honest
    jmu, jstd, jn = jax_honest_stats(jnp.asarray(u), jnp.asarray(mask))
    mu, std, n = honest_stats(torch.from_numpy(u), torch.from_numpy(mask))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), **TOL)
    assert n.item() == float(jn) == max(n_honest, 1)
    assert np.isfinite(std.numpy()).all()
    if n_honest <= 1:
        assert not std.any()


def test_registry():
    assert isinstance(get_attack(None), NoAttack)
    assert isinstance(get_attack("alie", num_clients=10), Alie)
    with pytest.raises(NotImplementedError, match="slice 3"):
        get_attack("ipm")
    with pytest.raises(ValueError, match="Unknown attack"):
        get_attack("nope")
