"""The port's ResNet-18/34 and WideResNet-28-10 (``models/resnet.py``,
``models/wrn.py``) against the JAX package's (``blades_tpu/models/resnet.py``,
``wrn.py``).

Full-width models are never built on the CPU: their flat layouts are held
to ``jax.eval_shape`` of the flax init against the port's modules built on
the ``meta`` device (D = 11,173,962 / 21,282,122 / 36,536,884). Everything
else runs on narrow twins with the full models' structure (ResNet-18's and
ResNet-34's stage sizes at widths 8 and 4, WideResNet-16-2, and
WideResNet-28-1 for WRN-28-10's 80 leaves), params from the flax init
carried over with ``params_from_jax``, inputs seeded numpy arrays handed to
both packages, at 32x32x3 and at MNIST's 28x28x1 (an odd size in the last
stage: 7 -> 4). Tolerances:

- layouts and the params' round trip: exact;
- eval logits and the train loss, f32: ``rtol=atol=1e-5``;
- the flat gradient, f32: each leaf within a relative L2 error of 1e-4.
  An elementwise bar does not hold the reference: the JAX package's own
  f32 gradient of the ResNet-34 twin is 1.2e-5 (relative L2) from the
  float64 gradient, with entries 5e-4 off in relative terms, where the
  port's is 1.9e-6 (measured on an x86 CPU, torch 2.13);
- a ReLU whose input lies within 3e-7 of 0 (found in a float64 forward of
  the port) may take the other side in each framework's f32 rounding, as
  CCT's max-pool ties do; the leaves at or before its layer then move by
  up to about 2e-3 of their size (WideResNet-16-2, seed 1: one GroupNorm
  output at -1.1e-7 in float64, positive in the port's f32). Those leaves
  are held to a relative L2 error of 2e-2, every later leaf to the bar
  above (``_relu_near_ties``);
- bf16 (``compute_dtype``) logits: relative L2 error at most 2e-2 against
  the JAX package's ``compute_dtype=jnp.bfloat16``. The bf16 gradient of
  these GroupNorm nets is far from the f32 one in both packages (the JAX
  package's own: 14%, 39% and 3.4% relative L2 on the three twins), so the
  port's bf16 gradient is held to the JAX package's f32 gradient no
  farther than 1.25 times the JAX package's own bf16 gradient is;
- WideResNet with ``dropout=0.3``: flax's ``jax.random.bernoulli`` is
  patched to hand out the port's keep-masks in flax's draw order.

Every test that takes gradients under ``torch.func.vmap`` turns torch's
"performance drop because we have not yet implemented the batching rule"
warning into an error: a missing batching rule would run the clients one
by one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import create_model as jax_create_model
from blades_tpu.models import resnet as jax_resnet
from blades_tpu.models import wrn as jax_wrn
from blades_tpu_torch.models import (
    MODELS,
    build_fns,
    create_model,
    params_from_jax,
    params_to_jax,
    resnet,
    wrn,
)
from blades_tpu_torch.ops.pytree import CONV2D, DENSE, ravel
from blades_tpu_torch.utils import rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL_L2 = 1e-4
TIE_REL_L2 = 2e-2
BF16_REL_L2 = 2e-2
BF16_GRAD_RATIO = 1.25
CIFAR, MNIST = (32, 32, 3), (28, 28, 1)
NO_BATCHING_RULE = pytest.mark.filterwarnings(
    "error:.*performance drop because we have not yet implemented the batching rule")

#: name -> (JAX module, port module), each built for a sample shape
TWINS = {
    "resnet18-w8": (lambda s: jax_resnet.ResNet(stage_sizes=(2, 2, 2, 2), width=8),
                    lambda s: resnet.ResNet((2, 2, 2, 2), width=8, in_channels=s[-1])),
    "resnet34-w4": (lambda s: jax_resnet.ResNet(stage_sizes=(3, 4, 6, 3), width=4),
                    lambda s: resnet.ResNet((3, 4, 6, 3), width=4, in_channels=s[-1])),
    "wrn16-2": (lambda s: jax_wrn.WideResNet(depth=16, widen_factor=2),
                lambda s: wrn.WideResNet(depth=16, widen_factor=2, in_channels=s[-1],
                                         image_hw=s[:2])),
}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_init(jspec):
    """The flax init's params at key 0, as numpy (jitted: one compile in
    place of an op-by-op trace)."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(jspec.init)(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _twin_params(name, shape):
    return _jax_init(jax_build_fns(TWINS[name][0](shape), shape))


def _twin(name, shape, **jax_build):
    """``(JAX spec, JAX params as numpy, port spec, port params)``; the
    params are made once per twin and shape."""
    jmod, tmod = TWINS[name]
    jspec = jax_build_fns(jmod(shape), shape, **jax_build)
    jparams = _twin_params(name, shape)
    spec = build_fns(tmod(shape))
    return jspec, jparams, spec, params_from_jax(jparams, spec.layout)



def _batch(n, shape, seed=0):
    r = np.random.RandomState(seed)
    return r.randn(n, *shape).astype(np.float32), r.randint(0, 10, n).astype(np.int32)


def _jax_order(tree):
    return [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name,classes,dim,leaves", [
    ("resnet18", 10, 11_173_962, 62),
    ("resnet34", 10, 21_282_122, 110),
    ("wrn_28_10", 100, 36_536_884, 80),
    ("wrn_28_10", 10, 36_479_194, 80),
])
def test_full_width_layout_matches_ravel_pytree(name, classes, dim, leaves):
    """D, the leaf order (``BasicBlock_10`` before ``BasicBlock_2``) and
    every leaf's flax shape, from shapes alone."""
    jspec = jax_build_fns(jax_create_model(name, num_classes=classes), CIFAR)
    shapes = jax.eval_shape(jspec.init, jax.random.PRNGKey(0))
    with torch.device("meta"):
        spec = build_fns(create_model(name, num_classes=classes, sample_shape=CIFAR))
    flat = jax.tree_util.tree_leaves(shapes)
    assert spec.layout.dim == spec.param_count == sum(x.size for x in flat) == dim
    assert len(spec.layout.leaves) == leaves
    assert [leaf.jax_path for leaf in spec.layout.leaves] == _jax_order(shapes)
    assert [leaf.flax_shape for leaf in spec.layout.leaves] == [x.shape for x in flat]
    if name == "resnet34":
        blocks = [p[0] for p in _jax_order(shapes) if p[0].startswith("BasicBlock_")]
        assert blocks.index("BasicBlock_10") < blocks.index("BasicBlock_2")


@pytest.mark.parametrize("jmod,tmod", [
    (lambda: jax_resnet.ResNet(stage_sizes=(2, 2, 2, 2), width=8),
     lambda: resnet.ResNet((2, 2, 2, 2), width=8)),
    (lambda: jax_resnet.ResNet(stage_sizes=(3, 4, 6, 3), width=4),
     lambda: resnet.ResNet((3, 4, 6, 3), width=4)),
    (lambda: jax_wrn.WideResNet(depth=28, widen_factor=1, num_classes=100),
     lambda: wrn.WideResNet(depth=28, widen_factor=1, num_classes=100)),
], ids=["resnet18-w8", "resnet34-w4", "wrn28-1"])
def test_params_round_trip_and_flat_order(jmod, tmod):
    """The flax init's params through ``params_from_jax``, ``ravel`` equal
    to ``ravel_pytree``, and back through ``params_to_jax``; the port's
    own init round-trips too."""
    jparams = _jax_init(jax_build_fns(jmod(), CIFAR))
    spec = build_fns(tmod())
    assert [leaf.jax_path for leaf in spec.layout.leaves] == _jax_order(jparams)
    params = params_from_jax(jparams, spec.layout)
    np.testing.assert_array_equal(ravel(params, spec.layout).numpy(),
                                  np.asarray(ravel_pytree(jparams)[0]))
    tree = params_to_jax(params, spec.layout)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    own = spec.init(torch.Generator().manual_seed(3))
    again = params_from_jax(params_to_jax(own, spec.layout), spec.layout)
    for name, t in own.items():
        torch.testing.assert_close(again[name], t, rtol=0, atol=0)
    perms = {leaf.jax_path[-2:]: leaf.perm for leaf in spec.layout.leaves}
    assert perms[("Conv_0", "kernel")] == CONV2D and perms[("Dense_0", "kernel")] == DENSE


def test_init_matches_flax_distributions():
    params = build_fns(resnet.ResNet18()).init(torch.Generator().manual_seed(0))
    # kaiming_normal: std sqrt(2/fan_in), truncated at 2 sigma, rescaled
    w = params["blocks.4.conv2.weight"]  # 256 x 256 x 3 x 3
    std = (2 / (3 * 3 * 256)) ** 0.5
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    # lecun_normal on the head: std sqrt(1/512)
    fc = params["fc.weight"]
    assert abs(fc.std().item() - (1 / 512) ** 0.5) < 0.05 * (1 / 512) ** 0.5
    for name in ("stem_norm", "blocks.2.proj_norm", "blocks.7.norm2"):
        assert torch.all(params[f"{name}.weight"] == 1)
        assert torch.count_nonzero(params[f"{name}.bias"]) == 0
    assert torch.count_nonzero(params["fc.bias"]) == 0
    assert "blocks.1.proj.weight" not in params  # stage 1 keeps its width


def test_group_norm_groups_and_epsilon():
    """``min(8, C)`` groups (a 4-wide twin has 4), epsilon 1e-6."""
    m = resnet.ResNet((3, 4, 6, 3), width=4)
    assert m.stem_norm.num_groups == 4 and m.blocks[3].norm1.num_groups == 8
    assert resnet.GN_EPS == 1e-6


def _jax_forward_and_grad(jspec, jparams, x, y):
    """``(eval logits, train loss, top1, flat gradient)`` of the JAX
    package's model, from one compiled program."""
    def both(p):
        xj, yj = jnp.asarray(x), jnp.asarray(y)
        value, grads = jax.value_and_grad(
            lambda q: jspec.train_loss_fn(q, xj, yj, jax.random.PRNGKey(1)), has_aux=True)(p)
        return jspec.eval_logits_fn(p, xj), value, grads

    logits, (loss, aux), grads = jax.jit(both)(jparams)
    return (np.asarray(logits, np.float32), float(loss), float(aux["top1"]),
            np.asarray(ravel_pytree(grads)[0]))


def _torch_forward_and_grad(spec, params, x, y, noise=None):
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    logits = spec.eval_logits_fn(params, xt).float().detach().numpy()
    grads, (loss, aux) = torch.func.grad_and_value(
        lambda p: spec.train_loss_fn(p, xt, yt, noise), has_aux=True)(params)
    return logits, float(loss), float(aux["top1"]), ravel(grads, spec.layout).numpy()


def _relu_near_ties(spec, params, x, noise=None, eps=3e-7):
    """The layer depth (-1 the stem, i block i, ``len(blocks)`` after the
    last block) of every ReLU input within ``eps`` of 0 in a float64
    forward of the port."""
    from torch.overrides import TorchFunctionMode

    module = spec.module
    depth, ties = [-1], []
    hooks = []
    for i, block in enumerate(module.blocks):
        hooks.append(block.register_forward_pre_hook(
            lambda mod, args, i=i: depth.__setitem__(0, i)))
        hooks.append(block.register_forward_hook(
            lambda mod, args, out, i=i: depth.__setitem__(0, i + 1)))

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.nn.functional.relu and bool((args[0].abs() < eps).any()):
                ties.append(depth[0])
            return func(*args, **(kwargs or {}))

    p64 = {n: t.double() for n, t in params.items()}
    try:
        with Record():
            torch.func.functional_call(module, p64, (torch.from_numpy(x).double(),),
                                       {"noise": noise} if noise else {})
    finally:
        for h in hooks:
            h.remove()
    return ties


def _leaf_depth(name, num_blocks):
    if name.startswith("blocks."):
        return int(name.split(".")[1])
    return {"stem": -1, "stem_norm": -1, "norm": num_blocks}.get(name.split(".")[0],
                                                                 num_blocks + 1)


def _assert_grads_match(spec, grad, jgrad, ties):
    """Every leaf within ``GRAD_REL_L2``, but those at or before the
    deepest ReLU near-tie, which are held to ``TIE_REL_L2``."""
    deepest = max(ties, default=-2)
    off = 0
    for leaf in spec.layout.leaves:
        a, b = grad[off:off + leaf.size], jgrad[off:off + leaf.size]
        off += leaf.size
        tied = _leaf_depth(leaf.name, len(spec.module.blocks)) <= deepest
        assert _rel_l2(a, b) <= (TIE_REL_L2 if tied else GRAD_REL_L2), leaf.name


@pytest.mark.parametrize("shape", [CIFAR, MNIST], ids=["32x32x3", "28x28x1"])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_forward_and_grad_match_jax(name, shape):
    """Eval logits, train loss and top-1, and the flat gradient, f32."""
    jspec, jparams, spec, params = _twin(name, shape)
    assert spec.noise_sites(4) == {}
    x, y = _batch(4, shape, seed=1)
    jlogits, jloss, jtop1, jgrad = _jax_forward_and_grad(jspec, jparams, x, y)
    logits, loss, top1, grad = _torch_forward_and_grad(spec, params, x, y)
    np.testing.assert_allclose(logits, jlogits, **TOL)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert top1 == jtop1
    _assert_grads_match(spec, grad, jgrad, _relu_near_ties(spec, params, x))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_bf16_logits_and_grad_match_jax(name):
    jspec32, jparams, _, _ = _twin(name, CIFAR)
    jspec = jax_build_fns(TWINS[name][0](CIFAR), CIFAR, compute_dtype=jnp.bfloat16)
    spec = build_fns(TWINS[name][1](CIFAR), compute_dtype=torch.bfloat16)
    params = params_from_jax(jparams, spec.layout)
    x, y = _batch(4, CIFAR, seed=2)
    want, _, _, jgrad = _jax_forward_and_grad(jspec, jparams, x, y)
    got, _, _, grad = _torch_forward_and_grad(spec, params, x, y)
    assert _rel_l2(got, want) <= BF16_REL_L2
    exact = _jax_forward_and_grad(jspec32, jparams, x, y)[3]
    assert _rel_l2(grad, exact) <= BF16_GRAD_RATIO * _rel_l2(jgrad, exact)


@pytest.mark.parametrize("shape", [CIFAR, MNIST], ids=["32x32x3", "28x28x1"])
def test_wrn_dropout_masks_injected_match_jax(monkeypatch, shape):
    """WideResNet-16-2 with ``dropout=0.3``: one NHWC site per block, the
    port's masks handed to flax in its draw order."""
    jmod = jax_wrn.WideResNet(depth=16, widen_factor=2, dropout=0.3)
    jspec = jax_build_fns(jmod, shape)
    jparams = _jax_init(jspec)
    spec = build_fns(wrn.WideResNet(depth=16, widen_factor=2, dropout=0.3,
                                    in_channels=shape[-1], image_hw=shape[:2]))
    sites = spec.noise_sites(4)
    hw = [(shape[0], shape[1])] * 2 + [((shape[0] + 1) // 2,) * 2] * 2 + [
        ((shape[0] + 3) // 4,) * 2] * 2
    assert list(sites) == [f"blocks.{i}.drop" for i in range(6)]
    assert [v[0] for v in sites.values()] == [(4, *hw[i], c) for i, c in
                                             enumerate([32, 32, 64, 64, 128, 128])]
    assert all(v[1] == pytest.approx(0.7) for v in sites.values())
    noise = rng.keep_masks(sites, torch.Generator().manual_seed(5))
    queue = [jnp.asarray(m.numpy()) for m in noise.values()]

    def bernoulli(key, p=0.5, shape=None, **kw):
        mask = queue.pop(0)
        assert tuple(shape) == mask.shape and p == pytest.approx(0.7)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    x, y = _batch(4, shape, seed=3)
    _, jloss, jtop1, jgrad = _jax_forward_and_grad(jspec, jparams, x, y)
    assert queue == []
    params = params_from_jax(jparams, spec.layout)
    _, loss, top1, grad = _torch_forward_and_grad(spec, params, x, y, noise)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert top1 == jtop1
    _assert_grads_match(spec, grad, jgrad, _relu_near_ties(spec, params, x, noise))
    with pytest.raises(ValueError, match="keep-masks"):
        spec.train_loss_fn(params, torch.from_numpy(x), torch.from_numpy(y))


@NO_BATCHING_RULE
@pytest.mark.parametrize("name", ["resnet18-w8", "wrn16-2"])
def test_vmapped_client_grads_equal_each_clients(name):
    """The engine's step: ``vmap(grad_and_value)`` over per-client params
    and batches (grouped convs, GroupNorm with per-client scales) equals
    each client's own gradient, with no batching-rule fallback. In float64,
    where no ReLU input lies near enough to 0 for the two summation orders
    to send it to other sides."""
    spec = build_fns(TWINS[name][1](CIFAR))
    base = spec.init(torch.Generator().manual_seed(1))
    n = 3
    g = torch.Generator().manual_seed(2)
    p = {k: (v + 0.01 * torch.randn((n, *v.shape), generator=g)).double()
         for k, v in base.items()}
    x = torch.randn(n, 2, *CIFAR, generator=g, dtype=torch.float64)
    y = torch.randint(0, 10, (n, 2), generator=g)
    fn = torch.func.grad_and_value(lambda q, a, b: spec.train_loss_fn(q, a, b), has_aux=True)
    grads, (loss, _) = torch.func.vmap(fn)(p, x, y)
    for i in range(n):
        gi, (li, _) = fn({k: v[i] for k, v in p.items()}, x[i], y[i])
        torch.testing.assert_close(loss[i], li, rtol=1e-10, atol=1e-12)
        for k in gi:
            torch.testing.assert_close(grads[k][i], gi[k], rtol=1e-9, atol=1e-12)


def test_registry_names_and_kwargs():
    """``resnet18``, ``resnet34`` and ``wrn_28_10`` resolve (on ``meta``:
    no full-width weights on the CPU); the ResNets drop extra keyword arguments,
    as the JAX registry's lambdas do, ``wrn_28_10`` takes them; the input
    channels come from ``sample_shape``."""
    assert {"resnet18", "resnet34", "wrn_28_10"} <= set(MODELS)
    with torch.device("meta"):
        r18 = create_model("resnet18", num_classes=10, sample_shape=MNIST, dropout=0.5)
        r34 = create_model("resnet34", num_classes=100, sample_shape=CIFAR)
        w = create_model("wrn_28_10", num_classes=100, sample_shape=CIFAR, dropout=0.3)
    assert isinstance(r18, resnet.ResNet) and r18.stem.in_channels == 1
    assert len(r18.blocks) == 8 and len(r34.blocks) == 16 and r34.fc.out_features == 100
    assert isinstance(w, wrn.WideResNet) and len(w.blocks) == 12
    assert w.blocks[0].rate == 0.3 and w.fc.in_features == 640
    assert build_fns(w).noise_sites(2)["blocks.11.drop"] == ((2, 8, 8, 640), 0.7)
    # every name of the JAX registry is ported (the text models in slice
    # 11b); an unknown one raises as the JAX registry's does
    with pytest.raises(ValueError, match="available"):
        create_model("no_such_model")
    from blades_tpu_torch.models import cct, cifar10, mlp, mnist

    assert cifar10.CCTNet is cct.CCTNet and cifar10.cct_2_3x2_32 is cct.cct_2_3x2_32
    assert mnist.MLP is mlp.MLP and mnist.create_model is mlp.create_mnist_model
