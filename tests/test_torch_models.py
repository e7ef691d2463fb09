"""The port's MLP and flat layout against the JAX package's.

Same params (drawn by the JAX package's init, carried over with
``params_from_jax``) and the same seeded-numpy batch go through both models.
The flat order must match exactly; logits, loss and the flat gradient within
f32 ``rtol=1e-5, atol=1e-6`` (CPU matmuls in two frameworks sum in different
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu_torch.models import create_mnist_model, params_from_jax, params_to_jax
from blades_tpu_torch.ops.pytree import flat_dim, make_unraveler, ravel

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def specs():
    return jax_mlp(), create_mnist_model()


@pytest.fixture(scope="module")
def jax_params(specs):
    jspec, _ = specs
    params = jspec.init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 28, 28, 1).astype(np.float32), rng.randint(0, 10, n).astype(np.int32)


def test_mlp_dim_and_flat_order(specs, jax_params):
    _, tspec = specs
    params = params_from_jax(jax_params, tspec.layout)
    assert tspec.layout.dim == flat_dim(params) == tspec.param_count == 59_850
    expect, _ = ravel_pytree(jax_params)
    np.testing.assert_array_equal(ravel(params, tspec.layout).numpy(), np.asarray(expect))
    # flax order: keys sorted per level, so a layer's bias precedes its kernel
    assert [leaf.jax_path for leaf in tspec.layout.leaves][:2] == [
        ("Dense_0", "bias"), ("Dense_0", "kernel"),
    ]


def test_unravel_inverts_ravel(specs, jax_params):
    _, tspec = specs
    params = params_from_jax(jax_params, tspec.layout)
    d, unravel = make_unraveler(params, tspec.layout)
    flat = ravel(params, tspec.layout)
    back = unravel(flat)
    assert d == flat.numel()
    for name, t in params.items():
        assert back[name].shape == t.shape
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)


def test_params_round_trip(specs, jax_params):
    _, tspec = specs
    tree = params_to_jax(params_from_jax(jax_params, tspec.layout), tspec.layout)
    for layer, leaves in jax_params.items():
        for name, arr in leaves.items():
            np.testing.assert_array_equal(tree[layer][name], arr)
    own = tspec.init(torch.Generator().manual_seed(3))
    again = params_from_jax(params_to_jax(own, tspec.layout), tspec.layout)
    for name, t in own.items():
        torch.testing.assert_close(again[name], t, rtol=0, atol=0)


def test_init_matches_flax_distribution(specs):
    # lecun_normal kernels (std sqrt(1/fan_in), truncated at 2 sigma), zero biases
    _, tspec = specs
    params = tspec.init(torch.Generator().manual_seed(0))
    w = params["layers.0.weight"]
    assert w.shape == (64, 784)
    assert abs(w.std().item() - (1 / 784) ** 0.5) < 0.05 * (1 / 784) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 784) ** 0.5 / 0.87962566103423978 + 1e-6
    assert torch.count_nonzero(params["layers.0.bias"]) == 0


def test_logits_loss_and_grad_match_jax(specs, jax_params):
    jspec, tspec = specs
    x, y = _batch()
    key = jax.random.PRNGKey(1)
    jloss, jaux = jspec.train_loss_fn(jax_params, jnp.asarray(x), jnp.asarray(y), key)
    jgrads = jax.grad(lambda p: jspec.train_loss_fn(p, jnp.asarray(x), jnp.asarray(y), key)[0])(
        jax_params
    )
    jlogits = jspec.eval_logits_fn(jax_params, jnp.asarray(x))

    params = params_from_jax(jax_params, tspec.layout)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    tloss, taux = tspec.train_loss_fn(params, xt, yt)
    tgrads = torch.func.grad(lambda p: tspec.train_loss_fn(p, xt, yt)[0])(params)
    tlogits = tspec.eval_logits_fn(params, xt)

    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL)
    assert taux["top1"].item() == pytest.approx(float(jaux["top1"]))
    np.testing.assert_allclose(
        ravel(tgrads, tspec.layout).numpy(), np.asarray(ravel_pytree(jgrads)[0]), **TOL
    )
