"""``remat=True``: each client's clamped loss rematerialized
(``blades_tpu_torch/ops/remat.py``, the JAX engine's ``jax.checkpoint``).

Held to the JAX package's ``remat=True`` (the MLP at K=10 and a narrow CCT
twin, their inputs drawn once with numpy and handed to both, attention
dropout and stochastic depth at 0 on both sides, as in
``tests/test_torch_engine_cct.py``: the two packages draw different
bits), to the JAX test ``test_client_chunks_match_single_vmap``'s contract
(4 chunks with remat against one chunk without, ``rtol=1e-5, atol=1e-7``),
and to the port's own round without remat: f32, bf16, a CCT twin with its
dropout and DropPath masks on, persistent Adam, the streaming round, the
async tick and vmap mode. On the CPU the remat round equals the round
without it bit for bit in every case here (the recomputed forward is the
same code on the same inputs and masks); the tests assert that.
"""

import numpy as np
import pytest
import torch

from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.asyncfl import AsyncConfig
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.core import ClientOptSpec, ExperimentBatch, RoundEngine
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.models import build_fns, cct, create_mnist_model, params_from_jax
from blades_tpu_torch.models.mlp import MLP
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.ops.remat import remat
from blades_tpu_torch.utils import rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)  # one K=10 MLP round, port against JAX (PERF.md section 2)
PARAMS_BAR = dict(rtol=1e-5, atol=1e-7)  # the remat bar on the params


def _twin(**kw):
    """A narrow CCT: one encoder layer of width 16 on 16x16 images."""
    return dict(num_classes=10, img_size=16, embedding_dim=16, num_layers=1, num_heads=2,
                mlp_ratio=1.0, kernel_size=3, n_conv_layers=1, **kw)


NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)


# -- the function itself -------------------------------------------------------------


def test_remat_gradient_is_the_gradient_under_nested_vmap():
    """``vmap(vmap(grad_and_value(remat(f))))``, the batched round's shape:
    the gradient, loss and aux equal those without remat bit for bit."""
    spec = create_mnist_model()
    params = spec.init(rng.generator(0, 0, rng.INIT))
    g = torch.Generator().manual_seed(1)
    x, y = torch.randn(4, 8, 28, 28, 1, generator=g), torch.randint(0, 10, (4, 8), generator=g)
    stacked = {n: torch.stack([t.expand(4, *t.shape), 1.01 * t.expand(4, *t.shape)])
               for n, t in params.items()}

    def f(p, x, y, noise):
        loss, aux = spec.train_loss_fn(p, x, y, noise)
        return torch.clamp(loss, 0.0, 1e6), aux

    outs = []
    for fn in (f, remat(f)):
        step = torch.func.vmap(torch.func.grad_and_value(fn, has_aux=True))
        with torch.no_grad():
            outs.append(torch.func.vmap(step, in_dims=(0, None, None, None))(stacked, x, y, {}))
    (g0, (l0, a0)), (g1, (l1, a1)) = outs
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert torch.equal(l0, l1) and torch.equal(a0["top1"], a1["top1"])


# -- against the JAX package ---------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
    from blades_tpu.attackers.alie import Alie as JaxAlie
    from blades_tpu.core import RoundEngine as JaxRoundEngine
    from blades_tpu.models import build_fns as jax_build_fns
    from blades_tpu.models import cct as jax_cct
    from blades_tpu.models.mlp import create_mnist_model as jax_mlp

    return dict(jax=jax, jnp=jnp, ravel=ravel_pytree, TM=JaxTrimmedmean, Alie=JaxAlie,
                RE=JaxRoundEngine, build=jax_build_fns, cct=jax_cct, mlp=jax_mlp)


def _jax_and_port_rounds(jx, jspec, tspec, k, f, b, cx, cy, chunks=1):
    jax, jnp = jx["jax"], jx["jnp"]
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, tspec.layout)
    jeng = jx["RE"](jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=k,
                    num_byzantine=f, attack=jx["Alie"](num_clients=k, num_byzantine=f),
                    aggregator=jx["TM"](num_byzantine=b), plan=None, client_chunks=chunks,
                    keep_updates=True, remat=True)
    teng = RoundEngine(tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout,
                       num_clients=k, num_byzantine=f,
                       attack=get_attack("alie", num_clients=k, num_byzantine=f),
                       aggregator=get_aggregator("trimmedmean", num_byzantine=b),
                       client_chunks=chunks, keep_updates=True, device="cpu",
                       noise_sites=tspec.noise_sites, remat=True)
    jstate, _ = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy), 0.1, 1.0,
                               jax.random.PRNGKey(7))
    tstate, _ = teng.run_round(teng.init(tparams), torch.from_numpy(cx), torch.from_numpy(cy),
                               0.1, 1.0)
    np.testing.assert_allclose(teng.last_updates.numpy(), np.asarray(jeng.last_updates), **TOL)
    np.testing.assert_allclose(ravel(tstate.params, tspec.layout).numpy(),
                               np.asarray(jx["ravel"](jstate.params)[0]), **PARAMS_BAR)


def test_mlp_remat_round_matches_jax_remat(jx):
    r = np.random.RandomState(100)
    cx = r.randn(10, 2, 8, 28, 28, 1).astype(np.float32)
    cy = r.randint(0, 10, (10, 2, 8)).astype(np.int32)
    _jax_and_port_rounds(jx, jx["mlp"](), create_mnist_model(), 10, 4, 4, cx, cy, chunks=2)


def test_cct_twin_remat_round_matches_jax_remat(jx):
    r = np.random.RandomState(101)
    cx = r.randn(4, 1, 2, 16, 16, 3).astype(np.float32)
    cy = r.randint(0, 10, (4, 1, 2)).astype(np.int32)
    jspec = jx["build"](jx["cct"].CCT(**_twin(**NO_NOISE)), (16, 16, 3))
    _jax_and_port_rounds(jx, jspec, build_fns(cct.CCT(**_twin(**NO_NOISE))), 4, 1, 1, cx, cy)


# -- against the round without remat --------------------------------------------------


@pytest.fixture(scope="module")
def mnist():
    return Synthetic(num_clients=8, train_size=400, test_size=100, noise=0.3,
                     cache=False).get_dls("cpu")


def test_client_chunks_match_single_vmap(mnist):
    """The JAX test of that name: 4 chunks with remat against one chunk
    without, within ``rtol=1e-5, atol=1e-7``."""
    spec = create_mnist_model()
    params = spec.init(rng.generator(0, 0, rng.INIT))
    cx, cy = mnist.sample_round(rng.generator(0, 1, rng.DATA), 2, 8)
    out = []
    for kw in ({}, {"client_chunks": 4, "remat": True}):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=8, aggregator=get_aggregator("mean"), device="cpu", **kw)
        state, _ = eng.run_round(eng.init(params), cx, cy, 0.1, 1.0, seed=2)
        out.append(ravel(state.params, spec.layout))
    torch.testing.assert_close(out[1], out[0], rtol=1e-5, atol=1e-7)


def _twin_store():
    return Synthetic(num_clients=6, sample_shape=(16, 16, 3), train_size=60, test_size=12,
                     cache=False).get_dls("cpu")


CASES = {
    "mlp_f32": dict(),
    "mlp_bf16": dict(dtype=torch.bfloat16),
    "mlp_persist_adam": dict(client_opt=ClientOptSpec(name="adam", persist=True),
                             client_chunks=2),
    "mlp_streaming": dict(streaming=True, client_chunks=3, attack="noise"),
    "mlp_async": dict(async_config=AsyncConfig(buffer_m=4, arrivals={
        "kind": "uniform", "max_delay": 2}, staleness="polynomial")),
    "cct_twin_masks": dict(model="cct"),
    "cct_twin_bf16_masks": dict(model="cct", dtype=torch.bfloat16, client_chunks=2),
}


def _rounds(case, flag):
    kw = dict(CASES[case])
    model, dtype = kw.pop("model", "mlp"), kw.pop("dtype", None)
    attack = kw.pop("attack", "alie")
    if model == "mlp":
        spec, store, k = create_mnist_model(), None, 8
    else:
        spec, store, k = build_fns(cct.CCT(**_twin())), _twin_store(), 6
    if dtype is not None:
        spec = build_fns(cct.CCT(**_twin()) if model == "cct" else MLP(784, 10),
                         compute_dtype=dtype)
    store = store or Synthetic(num_clients=8, train_size=200, test_size=40,
                               cache=False).get_dls("cpu")
    params = spec.init(rng.generator(0, 0, rng.INIT))
    eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                      num_clients=k, num_byzantine=2, attack=get_attack(attack),
                      aggregator=get_aggregator("trimmedmean", num_byzantine=2), device="cpu",
                      noise_sites=spec.noise_sites, remat=flag, **kw)
    state, losses = eng.init(params), []
    for r in range(2):
        cx, cy = store.sample_round(rng.generator(0, r + 1, rng.DATA), 2, 4)
        state, m = eng.run_round(state, cx, cy, 0.1, 1.0, seed=5)
        losses.append(m.train_loss)
    return state, torch.stack(losses)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_round_equals_the_round_without(case):
    (s1, l1), (s0, l0) = _rounds(case, True), _rounds(case, False)
    assert torch.equal(l1, l0)
    for name in s0.params:
        assert torch.equal(s1.params[name], s0.params[name]), name
    opt0 = torch.utils._pytree.tree_leaves(s0.client_opt_state)
    opt1 = torch.utils._pytree.tree_leaves(s1.client_opt_state)
    assert len(opt0) == len(opt1) and all(torch.equal(a, b) for a, b in zip(opt0, opt1))


def test_remat_under_vmap_mode():
    """``ExperimentBatch(mode="vmap")`` over a remat engine: the nested
    ``vmap`` of the remat Function, equal to the engine without remat."""
    store = Synthetic(num_clients=8, train_size=200, test_size=40, cache=False).get_dls("cpu")
    spec = create_mnist_model()
    params = spec.init(rng.generator(0, 0, rng.INIT))
    cx, cy = store.sample_round(rng.generator(0, 1, rng.DATA), 2, 4)
    out = []
    for flag in (True, False):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=8, num_byzantine=2, attack=get_attack("alie"),
                          aggregator=get_aggregator("trimmedmean", num_byzantine=2),
                          device="cpu", remat=flag, client_chunks=2)
        eb = ExperimentBatch(eng, 2, mode="vmap")
        states, _, _ = eb.run_round_batch(eb.init_batch(params), cx, cy, [0.1, 0.2],
                                          [1.0, 1.0], [3, 4], shared_data=True)
        out.append(states.params)
    assert all(torch.equal(out[0][n], out[1][n]) for n in out[0])
