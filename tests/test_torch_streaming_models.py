"""The port's streaming round with each streaming defense, with CCT-2 and
with persistent client state, against the JAX package's streaming round:
one K=7 MLP round per streaming defense; a K=6 CCT-2 streaming round; the
mean's CCT-2 streaming round against its dense round with dropout on;
persistent client state (``persist=True``) through the streaming round.
Draws are handed to JAX as ``tests/test_torch_streaming_rounds.py`` says;
rounds at ``rtol=1e-4, atol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.core import RoundEngine, RoundMetrics
from blades_tpu_torch.models import build_fns, cct, params_from_jax
from blades_tpu_torch.ops.pytree import ravel

from torch_streaming_helpers import (
    CASES,
    CCT_B,
    CCT_F,
    CCT_K,
    CLIENT_LR,
    EXACT_TOL,
    K,
    NO_NOISE,
    ROUND_TOL,
    SERVER_LR,
    _check_round,
    _id,
    _run_both,
    _stream_engines,
    jax_params,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_mlp_streaming_round_per_defense_matches_jax(jax_params, monkeypatch, case):
    """One K=7 MLP streaming round of 2 chunks (pad 1) with each streaming
    defense under sign flipping and 30% dropout, against JAX; stateful
    defenses' state too."""
    faults = dict(dropout_rate=0.3)
    j, t = _stream_engines(jax_params, case, ("signflipping", {}), faults)
    j, t, jm, tm = _run_both(monkeypatch, j, t, 0, seed=4)
    _check_round(j, t, jm, tm)


def test_cct2_streaming_round_matches_jax():
    """One K=6 CCT-2 streaming round (D = 283,723) in 4 requested chunks (3
    of 2), sign flipping f=2 and trimmed mean b=2, dropout and stochastic
    depth at 0 on both sides, against the JAX streaming engine."""
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), (32, 32, 3))
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tspec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=CCT_K,
        num_byzantine=CCT_F, attack=jax_get_attack("signflipping"),
        aggregator=jax_get_aggregator("trimmedmean", num_byzantine=2), plan=None,
        client_chunks=4, streaming=True,
    )
    tparams = params_from_jax(jparams, tspec.layout)
    teng = RoundEngine(
        tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout,
        num_clients=CCT_K, num_byzantine=CCT_F, attack=get_attack("signflipping"),
        aggregator=get_aggregator("trimmedmean", num_byzantine=2), client_chunks=4,
        device="cpu", noise_sites=tspec.noise_sites, streaming=True,
    )
    assert (teng.client_chunks, teng.chunk_size) == (jeng.client_chunks, jeng.chunk_size)
    rng = np.random.RandomState(203)
    cx = rng.randn(CCT_K, 1, CCT_B, 32, 32, 3).astype(np.float32)
    cy = rng.randint(0, 10, (CCT_K, 1, CCT_B)).astype(np.int32)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx),
                                torch.from_numpy(cy), CLIENT_LR, SERVER_LR)
    np.testing.assert_allclose(ravel(tstate.params, tspec.layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **ROUND_TOL)
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else ROUND_TOL["atol"]
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=ROUND_TOL["rtol"], atol=atol, err_msg=name)


def test_cct2_streaming_mean_round_equals_dense_with_dropout():
    """CCT-2 at its default dropout and DropPath rates, K=6 in 3 chunks:
    the streaming round draws the dense round's masks, so the mean's
    streaming round equals the dense one."""
    spec = build_fns(cct.cct_2_3x2_32())
    assert spec.noise_sites(CCT_B)
    params = spec.init(torch.Generator().manual_seed(4))
    rng = np.random.RandomState(204)
    cx = torch.from_numpy(rng.randn(CCT_K, 1, CCT_B, 32, 32, 3).astype(np.float32))
    cy = torch.from_numpy(rng.randint(0, 10, (CCT_K, 1, CCT_B)).astype(np.int64))
    out = []
    for on in (True, False):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=CCT_K, aggregator=get_aggregator("mean"),
                          client_chunks=3, device="cpu", noise_sites=spec.noise_sites,
                          streaming=on)
        state, m = eng.run_round(eng.init(params), cx, cy, CLIENT_LR, SERVER_LR, seed=3)
        out.append((ravel(state.params, spec.layout), float(m.train_loss)))
    torch.testing.assert_close(out[0][0], out[1][0], **EXACT_TOL)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-6)


@pytest.mark.parametrize("client_opt", [
    dict(name="sgd", momentum=0.9, weight_decay=1e-2, persist=True),
    dict(name="adam", persist=True),
], ids=["momentum", "adam"])
def test_persistent_client_state_streaming_rounds_match_jax(jax_params, monkeypatch,
                                                            client_opt):
    """K=7 MLP streaming rounds of 2 chunks (4 + 3, pad 1) with
    ``persist=True``, sign flipping and trimmed mean b=2 under 30% dropout
    (momentum two rounds of 2 local steps; Adam one round of one step: its
    first step ``g / (|g| + eps)`` turns a near-zero gradient's rounding
    into a step of order lr that every later gradient feels):
    each chunk trains from its rows of the stacked client state, and the
    new rows come back, against the JAX streaming round: the params and
    metrics, and every client's state (momentum's trace at ``ROUND_TOL``;
    Adam's count exactly, its moments and its params at the multi-round
    ``rtol=1e-3, atol=1e-5``, the params where every client's
    ``sqrt(nu_hat)`` exceeds 1e-6, as in ``tests/test_torch_engine.py``)."""
    adam_tol = dict(rtol=1e-3, atol=1e-5)
    faults = dict(dropout_rate=0.3)
    j, t = _stream_engines(jax_params, ("trimmedmean", {"num_byzantine": 2}),
                           ("signflipping", {}), faults, client_opt=client_opt)
    rows = jax.vmap(lambda x: ravel_pytree(x)[0])
    sgd = client_opt["name"] == "sgd"
    for rnd in range(2 if sgd else 1):
        j = (_stream_engines(jax_params, ("trimmedmean", {"num_byzantine": 2}),
                             ("signflipping", {}), faults, client_opt=client_opt)[0][0], j[1])
        j, t, jm, tm = _run_both(monkeypatch, j, t, rnd, seed=6, steps=None if sgd else 1)
        tpart, jpart = t[1].client_opt_state[-1], j[1].client_opt_state[-1]
        if client_opt["name"] == "sgd":
            _check_round(j, t, jm, tm)
            np.testing.assert_allclose(t[0]._ravel_rows(tpart).numpy(),
                                       np.asarray(rows(jpart.trace)), **ROUND_TOL)
            continue
        count, mu, nu = tpart
        np.testing.assert_array_equal(count.numpy(), np.asarray(jpart.count))
        assert count.tolist() == [1] * K
        np.testing.assert_allclose(t[0]._ravel_rows(mu).numpy(), np.asarray(rows(jpart.mu)),
                                   **adam_tol)
        np.testing.assert_allclose(t[0]._ravel_rows(nu).numpy(), np.asarray(rows(jpart.nu)),
                                   **adam_tol)
        nu_hat = np.asarray(rows(jpart.nu)) / (1 - 0.999 ** np.asarray(jpart.count)[:, None])
        ok = np.sqrt(nu_hat).min(axis=0) > 1e-6
        np.testing.assert_allclose(ravel(t[1].params, t[2]).numpy()[ok],
                                   np.asarray(ravel_pytree(j[1].params)[0])[ok], **adam_tol)
        assert ok.sum() > 0.5 * ok.size
