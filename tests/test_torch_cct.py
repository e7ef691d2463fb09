"""The port's CCT family against the JAX package's (``blades_tpu/models/cct.py``).

Params come from the JAX package's init, carried over with
``params_from_jax``; inputs are seeded numpy arrays handed to both packages.
Tolerances:

- flat layout: exact (the same floats in the same order, D = 283,723);
- eval logits of the six factories, f32: ``rtol=atol=1e-5`` (the two
  frameworks' CPU convolutions and matmuls sum in different orders);
- train-mode loss and flat gradient of CCT-2, f32: ``rtol=1e-4, atol=1e-6``,
  with attention dropout and stochastic depth at 0 on both sides, and at
  the default rates with the same keep-masks injected into both (the JAX
  side's ``jax.random.bernoulli`` is patched to hand out the port's masks
  in the order flax draws them);
- a max-pool window whose two largest entries are equal in exact
  arithmetic and one rounding step apart in each framework (in opposite
  order) sends that window's gradient to another position: the conv
  kernels' gradients then differ by up to about 1e-2 of their size. Every
  gradient comparison counts such windows (``_pool_argmax_flips``) and,
  where there is one, holds the two conv kernels to a relative L2 error of
  2e-2 and every other leaf to the tolerance above; the seed-2 batch has
  one (``test_max_pool_tie_moves_only_the_tokenizer_gradient``);
- bf16 (``compute_dtype``) logits and gradient against the JAX package's
  ``build_fns(compute_dtype=jnp.bfloat16)``: relative L2 error at most
  2e-2. Measured on this CPU: 3.8e-3 (logits) and 4.7e-3 (gradient); the
  two frameworks round to bf16 at different places (flax's LayerNorm
  statistics, softmax and GELU against torch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.flatten_util import ravel_pytree

from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu_torch.models import build_fns, cct, create_model, params_from_jax, params_to_jax
from blades_tpu_torch.models.common import drop_path, dropout
from blades_tpu_torch.ops.pytree import CONV2D, DENSE, make_unraveler, ravel
from blades_tpu_torch.utils import rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

SHAPE = (32, 32, 3)
FACTORIES = ["cct_2_3x2_32", "cct_4_3x2_32", "cct_6_3x1_32", "cct_7_3x1_32",
             "cvt_7_4_32", "vit_lite_7_4_32"]
TOL_EVAL = dict(rtol=1e-5, atol=1e-5)
TOL_TRAIN = dict(rtol=1e-4, atol=1e-6)
BF16_REL_L2 = 2e-2
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)


def _jax_params(name, **kw):
    spec = jax_build_fns(getattr(jax_cct, name)(**kw), SHAPE)
    return jax.tree_util.tree_map(np.asarray, spec.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def cct2_params():
    return _jax_params("cct_2_3x2_32")


def _batch(n, seed=0):
    r = np.random.RandomState(seed)
    return r.randn(n, *SHAPE).astype(np.float32), r.randint(0, 10, n).astype(np.int32)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def test_cct2_flat_layout_matches_ravel_pytree(cct2_params):
    spec = build_fns(create_model("cct_2_3x2_32", sample_shape=SHAPE))
    flat, _ = ravel_pytree(cct2_params)
    assert spec.layout.dim == spec.param_count == flat.size == 283_723
    jax_order = [tuple(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(cct2_params)[0]]
    assert [leaf.jax_path for leaf in spec.layout.leaves] == jax_order
    perms = {leaf.jax_path[-2:]: leaf.perm for leaf in spec.layout.leaves}
    assert perms[("Conv_0", "kernel")] == CONV2D and perms[("Dense_1", "kernel")] == DENSE
    params = params_from_jax(cct2_params, spec.layout)
    assert params["tokenizer.convs.1.weight"].shape == (128, 64, 3, 3)
    np.testing.assert_array_equal(ravel(params, spec.layout).numpy(), np.asarray(flat))
    # the unraveled views ravel back to the same vector
    _, unravel = make_unraveler(params, spec.layout)
    back = unravel(ravel(params, spec.layout))
    for name, t in params.items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)


def test_cct2_params_round_trip(cct2_params):
    spec = build_fns(create_model("cct_2_3x2_32", sample_shape=SHAPE))
    tree = params_to_jax(params_from_jax(cct2_params, spec.layout), spec.layout)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(cct2_params)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(cct2_params)):
        np.testing.assert_array_equal(a, b)
    own = spec.init(torch.Generator().manual_seed(3))
    again = params_from_jax(params_to_jax(own, spec.layout), spec.layout)
    for name, t in own.items():
        torch.testing.assert_close(again[name], t, rtol=0, atol=0)


def test_cct2_init_matches_flax_distributions():
    params = build_fns(cct.cct_2_3x2_32()).init(torch.Generator().manual_seed(0))
    # kaiming_normal: std sqrt(2/fan_in), truncated at 2 sigma, rescaled
    w = params["tokenizer.convs.1.weight"]
    std = (2 / (3 * 3 * 64)) ** 0.5
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    # truncated_normal(0.02) and (0.2): truncated at 2 sigma, not rescaled
    q = params["layers.0.self_attn.qkv.weight"]
    assert abs(q.std().item() - 0.02 * 0.87962566103423978) < 0.02 * 0.02
    assert q.abs().max().item() <= 0.04 + 1e-7
    assert params["positional_emb"].abs().max().item() <= 0.4 + 1e-6
    assert torch.all(params["norm.weight"] == 1) and torch.all(params["norm.bias"] == 0)
    assert torch.count_nonzero(params["fc.bias"]) == 0


@pytest.mark.parametrize("name", FACTORIES)
def test_eval_logits_match_jax(name):
    jparams = _jax_params(name)
    jspec = jax_build_fns(getattr(jax_cct, name)(), SHAPE)
    spec = build_fns(create_model(name, sample_shape=SHAPE))
    x, _ = _batch(2)
    want = np.asarray(jspec.eval_logits_fn(jparams, jnp.asarray(x)))
    got = spec.eval_logits_fn(params_from_jax(jparams, spec.layout), torch.from_numpy(x))
    assert spec.layout.dim == ravel_pytree(jparams)[0].size
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL_EVAL)


def _jax_loss_and_grad(jspec, jparams, x, y):
    key = jax.random.PRNGKey(1)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jspec.train_loss_fn(p, jnp.asarray(x), jnp.asarray(y), key), has_aux=True
    ))(jparams)
    return float(loss), float(aux["top1"]), np.asarray(ravel_pytree(grads)[0])


def _torch_loss_and_grad(spec, params, x, y, noise=None):
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    grads, (loss, aux) = torch.func.grad_and_value(
        lambda p: spec.train_loss_fn(p, xt, yt, noise), has_aux=True
    )(params)
    return float(loss), float(aux["top1"]), ravel(grads, spec.layout).numpy()


def test_train_loss_and_grad_match_jax_without_noise(cct2_params):
    jparams = cct2_params  # the rates draw nothing at init
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), SHAPE)
    spec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    assert spec.noise_sites(4) == {}
    x, y = _batch(4, seed=1)
    jloss, jtop1, jgrad = _jax_loss_and_grad(jspec, jparams, x, y)
    params = params_from_jax(jparams, spec.layout)
    loss, top1, grad = _torch_loss_and_grad(spec, params, x, y)
    np.testing.assert_allclose(loss, jloss, **TOL_TRAIN)
    assert top1 == jtop1
    _assert_grads_match(spec, grad, jgrad, _pool_argmax_flips(jparams, params, x))


@pytest.mark.parametrize("masks", ["drawn", "all_keep"])
def test_train_loss_and_grad_match_jax_with_injected_masks(cct2_params, monkeypatch, masks):
    spec = build_fns(cct.cct_2_3x2_32())
    sites = spec.noise_sites(4)
    # CCT-2's defaults: attention dropout 0.1 in both layers, DropPath 0.1 in
    # layer 1 only (the rates run 0 -> 0.1 over the layers)
    assert list(sites) == ["layers.0.attn.attn", "layers.1.attn.attn",
                           "layers.1.path1", "layers.1.path2"]
    assert sites["layers.0.attn.attn"] == ((4, 2, 64, 64), 0.9)
    assert sites["layers.1.path1"] == ((4,), 0.9)
    noise = rng.keep_masks(sites, torch.Generator().manual_seed(5))
    if masks == "all_keep":
        noise = {n: torch.ones_like(m) for n, m in noise.items()}
    else:
        noise["layers.1.path2"] = torch.tensor([True, False, True, False])
    queue = [jnp.asarray(m.numpy()) for m in noise.values()]  # flax's draw order

    def bernoulli(key, p=0.5, shape=None, **kw):
        mask = queue.pop(0)  # DropPath asks for [B, 1, 1], the port's site is [B]
        assert shape[0] == mask.shape[0] and np.prod(shape) == mask.size
        assert p == pytest.approx(0.9)
        return mask.reshape(shape)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    x, y = _batch(4, seed=1)
    jloss, jtop1, jgrad = _jax_loss_and_grad(
        jax_build_fns(jax_cct.cct_2_3x2_32(), SHAPE), cct2_params, x, y)
    assert queue == []
    params = params_from_jax(cct2_params, spec.layout)
    loss, top1, grad = _torch_loss_and_grad(spec, params, x, y, noise)
    np.testing.assert_allclose(loss, jloss, **TOL_TRAIN)
    assert top1 == jtop1
    _assert_grads_match(spec, grad, jgrad, _pool_argmax_flips(cct2_params, params, x))
    # a kept entry is scaled by 1/keep, so even all-keep masks are not the
    # deterministic forward
    eval_loss = float(F.cross_entropy(spec.eval_logits_fn(params, torch.from_numpy(x)),
                                      torch.from_numpy(y).long()))
    assert abs(loss - eval_loss) > 1e-4


def test_train_without_masks_raises():
    spec = build_fns(cct.cct_2_3x2_32())
    x, y = _batch(2)
    with pytest.raises(ValueError, match="keep-masks"):
        spec.train_loss_fn(spec.init(torch.Generator().manual_seed(0)),
                           torch.from_numpy(x), torch.from_numpy(y))


def test_mask_helpers():
    x = torch.randn(3, 5, 4)
    keep_all = torch.ones(3, dtype=torch.bool)
    # rate 0 and eval (no mask) are the identity; an all-keep mask scales by 1/keep
    assert torch.equal(drop_path(x, keep_all, 0.0), x)
    assert torch.equal(drop_path(x, None, 0.1), x)
    torch.testing.assert_close(drop_path(x, keep_all, 0.1), x / 0.9, rtol=0, atol=0)
    m = torch.rand(3, 5, 4) < 0.5
    torch.testing.assert_close(dropout(x, m, 0.25), torch.where(m, x / 0.75, 0.0))


@pytest.mark.parametrize("branch", ["path1", "path2"])
def test_dropped_sample_loses_exactly_its_branch(branch):
    torch.manual_seed(0)
    layer = cct.TransformerEncoderLayer(16, 2, 16, dropout=0.0, attention_dropout=0.0,
                                        drop_path_rate=0.1)
    x = torch.randn(3, 5, 16)
    keep = 0.9
    masks = {"path1": torch.ones(3, dtype=torch.bool), "path2": torch.ones(3, dtype=torch.bool)}
    masks[branch] = torch.tensor([True, False, True])
    with torch.no_grad():
        out = layer(x, masks)
        kept1, kept2 = (masks[k].float()[:, None, None] for k in ("path1", "path2"))
        h1 = layer.self_attn(layer.pre_norm(x))
        xn = layer.norm1(x + h1 / keep * kept1)
        h2 = layer.linear2(F.gelu(layer.linear1(xn), approximate="tanh"))
        want = xn + h2 / keep * kept2
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    if branch == "path2":
        assert torch.equal(out[1], xn[1])  # the dropped sample is the normed stream alone


def test_drawn_masks_keep_nine_in_ten():
    sites = cct.cct_2_3x2_32().noise_sites(32)
    masks = rng.keep_masks(sites, torch.Generator().manual_seed(0), (64,))
    assert {n: tuple(m.shape) for n, m in masks.items()} == {
        n: (64,) + shape for n, (shape, _) in sites.items()}
    attn = masks["layers.0.attn.attn"].float().mean().item()
    assert abs(attn - 0.9) < 2e-3  # 16.8M draws: sd 7e-5
    for name in ("layers.1.path1", "layers.1.path2"):
        assert abs(masks[name].float().mean().item() - 0.9) < 0.03  # 2048 draws: sd 6.6e-3
    assert not torch.equal(masks["layers.1.path1"], masks["layers.1.path2"])


def test_bf16_logits_and_grad_match_jax_bf16(cct2_params):
    jparams = cct2_params
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), SHAPE, compute_dtype=jnp.bfloat16)
    spec = build_fns(cct.cct_2_3x2_32(**NO_NOISE), compute_dtype=torch.bfloat16)
    params = params_from_jax(jparams, spec.layout)
    x, y = _batch(4, seed=3)
    jlogits = np.asarray(jspec.eval_logits_fn(jparams, jnp.asarray(x)), np.float32)
    logits = spec.eval_logits_fn(params, torch.from_numpy(x))
    assert logits.dtype == torch.bfloat16
    assert _rel_l2(logits.float().detach().numpy(), jlogits) <= BF16_REL_L2
    jloss, _, jgrad = _jax_loss_and_grad(jspec, jparams, x, y)
    loss, _, grad = _torch_loss_and_grad(spec, params, x, y)
    assert grad.dtype == np.float32  # gradients come back through the cast in f32
    assert _rel_l2(grad, jgrad) <= BF16_REL_L2
    assert abs(loss - jloss) <= BF16_REL_L2 * abs(jloss)


def _pool_argmax_flips(jparams, params, x) -> int:
    """Max-pool windows of the tokenizer whose argmax (after ReLU) differs
    between the two frameworks' own activations on batch ``x``."""
    conv = lambda h, k: jax.lax.conv_general_dilated(  # noqa: E731
        h, jnp.asarray(k), (1, 1), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
    pool = lambda h: jax.lax.reduce_window(  # noqa: E731
        jnp.maximum(h, 0), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)])
    argmax = lambda pre: F.max_pool2d(F.relu(pre), 3, 2, 1, return_indices=True)[1]  # noqa: E731
    tok, flips = jparams["Tokenizer_0"], 0
    jh, th = jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2)
    for i in (0, 1):
        jpre = conv(jh, tok[f"Conv_{i}"]["kernel"])
        with torch.no_grad():
            tpre = F.conv2d(th, params[f"tokenizer.convs.{i}.weight"], padding=1)
        jpre_t = torch.from_numpy(np.array(jpre).transpose(0, 3, 1, 2))
        torch.testing.assert_close(tpre, jpre_t, rtol=1e-5, atol=1e-4)
        flips += int((argmax(tpre) != argmax(jpre_t)).sum())
        jh, th = pool(jpre), F.max_pool2d(F.relu(tpre), 3, 2, 1)
    return flips


def _assert_grads_match(spec, grad, jgrad, flips):
    """Every leaf within ``TOL_TRAIN``, but where a max-pool window's argmax
    flipped (``flips > 0``) the tokenizer's conv kernels, which then differ
    by up to about 1e-2 of their size (relative L2 at most 2e-2)."""
    off = 0
    for leaf in spec.layout.leaves:
        g, jg = grad[off:off + leaf.size], jgrad[off:off + leaf.size]
        off += leaf.size
        if flips and leaf.jax_path[0] == "Tokenizer_0":
            assert _rel_l2(g, jg) < 2e-2, "/".join(leaf.jax_path)
        else:
            np.testing.assert_allclose(g, jg, **TOL_TRAIN, err_msg="/".join(leaf.jax_path))


def test_max_pool_tie_moves_only_the_tokenizer_gradient(cct2_params):
    jparams = cct2_params
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), SHAPE)
    spec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    params = params_from_jax(jparams, spec.layout)
    x, y = _batch(4, seed=2)
    flips = _pool_argmax_flips(jparams, params, x)  # 1 on the CPUs these tests were written on
    _, _, jgrad = _jax_loss_and_grad(jspec, jparams, x, y)
    _, _, grad = _torch_loss_and_grad(spec, params, x, y)
    _assert_grads_match(spec, grad, jgrad, flips)
    tok = np.concatenate([np.full(leaf.size, leaf.jax_path[0] == "Tokenizer_0")
                          for leaf in spec.layout.leaves])
    # with a flip the conv kernels' gradients really differ; without one they agree
    assert np.allclose(grad[tok], jgrad[tok], **TOL_TRAIN) == (flips == 0)
