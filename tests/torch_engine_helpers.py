"""Shared inputs, engines and checks of the engine tests
(``tests/test_torch_engine*.py``): BASELINE config 1's K=10 MLP engines of
both packages, the batches drawn once and handed to both, the K=6 CCT-2
engines, the fault draws handed to JAX, and the round and optimizer
checks. Not a test module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.attackers.alie import Alie as JaxAlie
from blades_tpu.core import ClientOptSpec as JaxClientOptSpec
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.core import ServerOptSpec as JaxServerOptSpec
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu_torch.aggregators import Trimmedmean, get_aggregator
from blades_tpu_torch.attackers import Alie, get_attack
from blades_tpu_torch.core import ClientOptSpec, RoundEngine, RoundMetrics, ServerOptSpec
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.models import create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.utils import rng as port_rng


K, F, S, B = 10, 4, 2, 8
CLIENT_LR, SERVER_LR = 0.1, 1.0
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_3 = dict(rtol=1e-3, atol=1e-5)


def _batches(rnd):
    rng = np.random.RandomState(100 + rnd)
    cx = rng.randn(K, S, B, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (K, S, B)).astype(np.int32)
    return cx, cy


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _engines(jax_params, client_chunks, attack=None, aggregator=None, trusted=None,
             faults=None, client_opt=None, server_opt=None):
    """The two engines; ``attack`` / ``aggregator``: ``(name, kwargs)`` for
    both registries (default ALIE and trimmed mean b=5); ``faults``: the
    kwargs of a fault model for both; ``client_opt`` / ``server_opt``: the
    kwargs of both packages' optimizer specs (default plain SGD)."""
    opts = dict(client_opt=(JaxClientOptSpec(**client_opt), ClientOptSpec(**client_opt))
                if client_opt else (JaxClientOptSpec(), ClientOptSpec()),
                server_opt=(JaxServerOptSpec(**server_opt), ServerOptSpec(**server_opt))
                if server_opt else (JaxServerOptSpec(), ServerOptSpec()))
    jspec, tspec = jax_mlp(), create_mnist_model()
    if attack is None:
        jattack, tattack = JaxAlie(num_clients=K, num_byzantine=F), Alie(num_clients=K,
                                                                           num_byzantine=F)
    else:
        jattack, tattack = jax_get_attack(*attack[:1], **attack[1]), get_attack(
            *attack[:1], **attack[1])
    if aggregator is None:
        jagg, tagg = JaxTrimmedmean(num_byzantine=5), Trimmedmean(num_byzantine=5)
    else:
        jagg = jax_get_aggregator(aggregator[0], **aggregator[1])
        tagg = get_aggregator(aggregator[0], **aggregator[1])
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jax_params,
        num_clients=K, num_byzantine=F, attack=jattack, aggregator=jagg,
        trusted_mask=None if trusted is None else jnp.asarray(trusted),
        plan=None, client_chunks=client_chunks, keep_updates=True,
        fault_model=None if faults is None else JaxFaultModel(**faults),
        **{n: pair[0] for n, pair in opts.items()},
    )
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = RoundEngine(
        tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout,
        num_clients=K, num_byzantine=F, attack=tattack, aggregator=tagg,
        trusted_mask=None if trusted is None else torch.from_numpy(trusted),
        client_chunks=client_chunks, keep_updates=True, device="cpu",
        fault_model=None if faults is None else FaultModel(**faults),
        **{n: pair[1] for n, pair in opts.items()},
    )
    jstate = jeng.init(jax_params)
    tstate = teng.init(tparams)
    return (jeng, jstate), (teng, tstate, tspec.layout)


def _round(jax_side, torch_side, rnd, seed=0):
    (jeng, jstate), (teng, tstate, layout) = jax_side, torch_side
    cx, cy = _batches(rnd)
    jstate, jm = jeng.run_round(
        jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR, SERVER_LR,
        jax.random.PRNGKey(7),
    )
    tstate, tm = teng.run_round(
        tstate, torch.from_numpy(cx), torch.from_numpy(cy), CLIENT_LR, SERVER_LR, seed=seed
    )
    return (jeng, jstate), (teng, tstate, layout), jm, tm


def _check_metrics(jm, tm, rtol):
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else 1e-5
        np.testing.assert_allclose(
            float(getattr(tm, name)), float(getattr(jm, name)),
            rtol=rtol, atol=atol, err_msg=name,
        )


def _flat_params(jstate, tstate, layout):
    return ravel(tstate.params, layout).numpy(), np.asarray(ravel_pytree(jstate.params)[0])


ATTACK_CASES = [("ipm", {}), ("signflipping", {}), ("labelflipping", {"num_classes": 10}),
                ("noise", {}), ("minmax", {}), ("minsum", {})]
AGG_CASES = [("median", {}), ("krum", {"num_byzantine": F}),
             ("multikrum", {"num_byzantine": F, "num_selected": 3}), ("geomed", {}),
             ("autogm", {}), ("centeredclipping", {}), ("clustering", {}),
             ("clustering", {"metric": "distance"}), ("clippedclustering", {}), ("fltrust", {}),
             ("dnc", {"num_byzantine": F})]


def _catalog_id(case):
    kind, (name, kw) = case
    return "-".join([kind, name, *(f"{a}{b}" for a, b in kw.items() if a != "num_byzantine")])


CCT_K, CCT_F, CCT_S, CCT_B = 6, 2, 1, 4
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)


def _cct_batches(seed):
    rng = np.random.RandomState(seed)
    cx = rng.randn(CCT_K, CCT_S, CCT_B, 32, 32, 3).astype(np.float32)
    cy = rng.randint(0, 10, (CCT_K, CCT_S, CCT_B)).astype(np.int32)
    return cx, cy


def _cct_engine(spec, params, client_chunks=1, attack=None, aggregator=None):
    return RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
        num_clients=CCT_K, num_byzantine=CCT_F,
        attack=attack or Alie(num_clients=CCT_K, num_byzantine=CCT_F),
        aggregator=aggregator or Trimmedmean(num_byzantine=2), client_chunks=client_chunks,
        keep_updates=True, device="cpu", noise_sites=spec.noise_sites,
    )


FAULTS = dict(dropout_rate=0.3, straggler_rate=0.2, corrupt_clients=(1, 2))
FAULT_SEED = 3  # the port's root seed: round 2 replays client 5's round-1 update
FAULT_AGGS = [("mean", {}), ("trimmedmean", {"num_byzantine": 5}), ("median", {}),
              ("krum", {"num_byzantine": F}),
              ("multikrum", {"num_byzantine": F, "num_selected": 3}), ("geomed", {}),
              ("autogm", {}), ("centeredclipping", {}), ("clustering", {}),
              ("clippedclustering", {}), ("fltrust", {}), ("byzantinesgd", {}),
              ("dnc", {"num_byzantine": F}), ("signguard", {})]


def _queue_fault_draws(monkeypatch, fm, dim, seed, rnd):
    """The port's fault draws of round ``rnd``, queued for the JAX package's
    ``jax.random.bernoulli``; returns the queue (empty once taken)."""
    draws = draw_faults(fm, K if dim == 59_850 else CCT_K, dim,
                        port_rng.generator(seed, rnd, port_rng.FAULT))
    queue = [draws[n].numpy() for n in ("drop", "straggle", "corrupt", "bitflip")
             if draws[n] is not None]

    def bernoulli(key, p=0.5, shape=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return queue


def _check_fault_round(jeng, jstate, teng, tstate, layout, jm, tm):
    ju, tu = np.asarray(jeng.last_updates), teng.last_updates
    np.testing.assert_allclose(tu.numpy(), ju, **TOL)  # NaN rows in both
    assert {n: int(v) for n, v in teng.last_fault_diag.items()} == {
        n: int(v) for n, v in jeng.last_fault_diag.items()}
    np.testing.assert_allclose(*_flat_params(jstate, tstate, layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])
    for n in ("stale", "age", "has"):
        np.testing.assert_allclose(tstate.fault_state[n].numpy(),
                                   np.asarray(jstate.fault_state[n]), **TOL)


MOMENTUM = dict(name="sgd", momentum=0.9, weight_decay=1e-2)
ADAM = dict(name="adam")
# Adam's step g / (sqrt(nu_hat) + 1e-8) turns the two frameworks' rounding
# in a near-zero gradient into a step of order lr: its params are held
# where every client's sqrt(nu_hat) exceeds this (in JAX's state)
ADAM_WELL_CONDITIONED = 1e-6
_rows = jax.vmap(lambda t: ravel_pytree(t)[0])
# a server step's rounding is about 1e-4 of lr, so TOL_3 holds steps above
# a tenth of lr
ADAM_NO_CANCELLATION = 0.1


def _well_conditioned(adam_state, no_cancellation=False):
    """The ``[D]`` coordinates where ``sqrt(nu_hat)`` of a JAX Adam state
    exceeds ``ADAM_WELL_CONDITIONED`` (every client's, for a stacked one)
    and, with ``no_cancellation``, ``|mu_hat|`` exceeds
    ``ADAM_NO_CANCELLATION * sqrt(nu_hat)``."""
    count = np.asarray(adam_state.count, np.float64)
    flat = _rows if count.ndim else (lambda t: ravel_pytree(t)[0])
    if count.ndim:  # stacked [K] client states
        count = count[:, None]
    nu_hat = np.sqrt(np.asarray(flat(adam_state.nu)) / (1 - 0.999 ** count))
    ok = nu_hat > ADAM_WELL_CONDITIONED
    if no_cancellation:
        mu_hat = np.asarray(flat(adam_state.mu)) / (1 - 0.9 ** count)
        ok &= np.abs(mu_hat) > ADAM_NO_CANCELLATION * nu_hat
    return np.atleast_2d(ok).all(axis=0)


def _check_client_state(teng, tstate, jstate):
    """The port's persistent client state against JAX's, client by client:
    momentum's trace, or Adam's count (exact), first and second moments."""
    tpart, jpart = tstate.client_opt_state[-1], jstate.client_opt_state[-1]
    if isinstance(tpart, dict):  # optax.trace
        np.testing.assert_allclose(teng._ravel_rows(tpart).numpy(),
                                   np.asarray(_rows(jpart.trace)), **TOL_3)
        return
    count, mu, nu = tpart
    np.testing.assert_array_equal(count.numpy(), np.asarray(jpart.count))
    assert count.dtype == torch.int32 and count.shape == (K,)
    np.testing.assert_allclose(teng._ravel_rows(mu).numpy(), np.asarray(_rows(jpart.mu)),
                               **TOL_3)
    np.testing.assert_allclose(teng._ravel_rows(nu).numpy(), np.asarray(_rows(jpart.nu)),
                               **TOL_3)


def _carry_into_port(jstate, tstate, layout):
    """The port's state with the JAX state's params and, for a server Adam,
    its moments and count."""
    server = tstate.server_opt_state
    if server and isinstance(server[-1], tuple):
        adam = jstate.server_opt_state[-1]
        server = server[:-1] + ((torch.tensor(np.asarray(adam.count)),
                                 params_from_jax(adam.mu, layout),
                                 params_from_jax(adam.nu, layout)),)
    return tstate._replace(params=params_from_jax(jstate.params, layout), server_opt_state=server)
