"""The port's attacks and honest_stats against the JAX package, on the same
seeded-numpy ``[K, D]`` matrix and byzantine mask. Tolerance f32
``rtol=1e-5, atol=1e-6``: masked moments summed in two frameworks' orders.
The noise attack's normals are drawn by the port and handed to the JAX
package by patching ``jax.random.normal``. Min-Max and Min-Sum bisect a
scale ``gamma`` in 20 steps from 10: both packages take the same 20
decisions, so ``gamma`` agrees to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.attackers.base import honest_stats as jax_honest_stats
from blades_tpu_torch.attackers import (
    ATTACKS, Alie, Ipm, Labelflipping, Minmax, Minsum, NoAttack, Noise, Signflipping,
    get_attack, honest_stats,
)
from blades_tpu_torch.attackers.noise import draw_normals
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

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
    # persistent per-client optimizer state is ported (slice 3b): the engine
    # keeps one stacked [K, ...] state
    from blades_tpu_torch.core import ClientOptSpec, RoundEngine
    from blades_tpu_torch.models import create_mnist_model

    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(0))
    eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                      num_clients=4, client_opt=ClientOptSpec(name="adam", persist=True),
                      device="cpu")
    count, mu, nu = eng.init(params).client_opt_state[-1]
    assert count.tolist() == [0] * 4 and all(m.shape[0] == 4 for m in mu.values())
    with pytest.raises(ValueError, match="Unknown attack"):
        get_attack("nope")


def test_registry_resolves_every_jax_name():
    from blades_tpu.attackers import ATTACKS as JAX_ATTACKS

    assert set(ATTACKS) == set(JAX_ATTACKS)
    classes = dict(noise=Noise, labelflipping=Labelflipping, signflipping=Signflipping,
                   alie=Alie, ipm=Ipm, minmax=Minmax, minsum=Minsum)
    for name, cls in classes.items():
        assert type(get_attack(name)) is cls
        assert get_attack(name).trains_dishonestly == jax_get_attack(name).trains_dishonestly
        assert get_attack(name).update_locality == jax_get_attack(name).update_locality


def _on_updates_both(name, u, mask, **kw):
    got, state = get_attack(name, **kw).on_updates(torch.from_numpy(u), torch.from_numpy(mask))
    expect, _ = jax_get_attack(name, **kw).on_updates(jnp.asarray(u), jnp.asarray(mask), None)
    assert state == ()
    return got.numpy(), np.asarray(expect)


@pytest.mark.parametrize("f", [0, 3, 11])
@pytest.mark.parametrize("epsilon", [0.5, 100.0])
def test_ipm_matches_jax(f, epsilon):
    u = _matrix()
    mask = np.arange(u.shape[0]) < f
    got, expect = _on_updates_both("ipm", u, mask, epsilon=epsilon)
    np.testing.assert_allclose(got, expect, **TOL)
    np.testing.assert_array_equal(got[f:], u[f:])
    if 0 < f < u.shape[0]:
        np.testing.assert_allclose(got[0], -epsilon * u[f:].mean(0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["minmax", "minsum"])
@pytest.mark.parametrize("f,seed", [(2, 0), (4, 1), (5, 2)])
def test_minmax_minsum_match_jax(name, f, seed):
    u = _matrix(k=12, d=40, seed=seed)
    mask = np.arange(12) < f
    got, expect = _on_updates_both(name, u, mask)
    np.testing.assert_allclose(got, expect, **TOL)
    np.testing.assert_array_equal(got[f:], u[f:])
    np.testing.assert_array_equal(got[:f], np.repeat(got[:1], f, 0))
    # the row sits inside the honest envelope it was bisected against
    gamma, mu, dev = get_attack(name).gamma(torch.from_numpy(u), torch.from_numpy(mask))
    assert 0.0 < float(gamma) < 20.0
    np.testing.assert_allclose(got[0], (mu + gamma * dev).numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("f", [1, 4])
def test_noise_matches_jax_with_injected_draws(monkeypatch, f):
    u = _matrix()
    mask = np.arange(u.shape[0]) < f
    attack = Noise(mean=0.2, std=0.05)
    got, _ = attack.on_updates(torch.from_numpy(u), torch.from_numpy(mask),
                               torch.Generator().manual_seed(9))
    z = draw_normals(u.shape, torch.Generator().manual_seed(9), "cpu").numpy()
    taken = []

    def normal(key, shape, dtype):
        taken.append(shape)
        return jnp.asarray(z, dtype)

    monkeypatch.setattr(jax.random, "normal", normal)
    expect, _ = jax_get_attack("noise", mean=0.2, std=0.05).on_updates(
        jnp.asarray(u), jnp.asarray(mask), jax.random.key(0))
    assert taken == [u.shape]
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_array_equal(got[f:].numpy(), u[f:])
    # another draw gives other noise on the byzantine rows only
    again, _ = attack.on_updates(torch.from_numpy(u), torch.from_numpy(mask),
                                 torch.Generator().manual_seed(10))
    assert not torch.equal(again[:f], got[:f]) and torch.equal(again[f:], got[f:])


def test_signflipping_matches_jax_per_client():
    """The port flips a chunk's ``{name: [k, ...]}`` gradients by row; the
    JAX hook sees one client's tree under vmap."""
    rng = np.random.RandomState(4)
    grads = {"w": rng.randn(5, 3, 4).astype(np.float32), "b": rng.randn(5, 4).astype(np.float32)}
    byz = np.array([True, False, True, False, False])
    got = Signflipping().on_grads({n: torch.from_numpy(g) for n, g in grads.items()},
                                  torch.from_numpy(byz))
    jax_attack = jax_get_attack("signflipping")
    for i in range(5):
        expect = jax_attack.on_grads({n: jnp.asarray(g[i]) for n, g in grads.items()},
                                     jnp.asarray(byz[i]))
        for n in grads:
            np.testing.assert_array_equal(got[n][i].numpy(), np.asarray(expect[n]))
    bf16 = Signflipping().on_grads({"w": torch.ones(2, 3, dtype=torch.bfloat16)},
                                   torch.tensor([True, False]))["w"]
    assert bf16.dtype == torch.bfloat16 and bf16[0].eq(-1).all() and bf16[1].eq(1).all()


@pytest.mark.parametrize("num_classes", [10, 3])
def test_labelflipping_matches_jax_per_client(num_classes):
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6, 2).astype(np.float32)
    y = rng.randint(0, num_classes, (4, 6)).astype(np.int32)
    byz = np.array([True, False, False, True])
    tx, ty = Labelflipping().on_batch(torch.from_numpy(x), torch.from_numpy(y),
                                      torch.from_numpy(byz), num_classes=num_classes)
    jax_attack = jax_get_attack("labelflipping")
    for i in range(4):
        _, jy = jax_attack.on_batch(jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(byz[i]),
                                    num_classes=num_classes, key=None)
        np.testing.assert_array_equal(ty[i].numpy(), np.asarray(jy))
    assert torch.equal(tx, torch.from_numpy(x))
    np.testing.assert_array_equal(ty[0].numpy(), num_classes - 1 - y[0])
