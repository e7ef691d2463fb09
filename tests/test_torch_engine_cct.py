"""One K=6 CCT-2 round of the port (D = 283,723) against
``blades_tpu.core.RoundEngine``, under ALIE and sign flipping with trimmed
mean, and the round's independence of the client chunking at the default
rates. Inputs and tolerances as ``tests/test_torch_engine.py`` states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.models import build_fns as jax_build_fns
from blades_tpu.models import cct as jax_cct
from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.models import build_fns, cct, params_from_jax
from blades_tpu_torch.ops.pytree import ravel

from torch_engine_helpers import (
    CCT_B,
    CCT_F,
    CCT_K,
    CLIENT_LR,
    NO_NOISE,
    SERVER_LR,
    TOL,
    _cct_batches,
    _cct_engine,
    _check_metrics,
    _flat_params,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401


@pytest.mark.parametrize("attack,aggregator", [
    ("alie", ("trimmedmean", {"num_byzantine": 2})),
    ("signflipping", ("median", {})),
])
def test_cct2_round_matches_jax(attack, aggregator):
    """One CCT-2 round (D = 283,723), ALIE + trimmed mean b=2 and sign
    flipping + median, with attention dropout and stochastic depth at 0 on
    both sides (the two packages draw different bits), within the file's
    ``TOL``."""
    jspec = jax_build_fns(jax_cct.cct_2_3x2_32(**NO_NOISE), (32, 32, 3))
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tspec = build_fns(cct.cct_2_3x2_32(**NO_NOISE))
    attack_kws = dict(num_clients=CCT_K, num_byzantine=CCT_F) if attack == "alie" else {}
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams,
        num_clients=CCT_K, num_byzantine=CCT_F,
        attack=jax_get_attack(attack, **attack_kws),
        aggregator=jax_get_aggregator(aggregator[0], **aggregator[1]), plan=None,
        keep_updates=True,
    )
    tparams = params_from_jax(jparams, tspec.layout)
    teng = _cct_engine(tspec, tparams, attack=get_attack(attack, **attack_kws),
                       aggregator=get_aggregator(aggregator[0], **aggregator[1]))
    cx, cy = _cct_batches(200)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx),
                                torch.from_numpy(cy), CLIENT_LR, SERVER_LR)
    tu = teng.last_updates
    assert tu.shape == (CCT_K, 283_723)
    np.testing.assert_allclose(tu.numpy(), np.asarray(jeng.last_updates), **TOL)
    np.testing.assert_allclose(*_flat_params(jstate, tstate, tspec.layout), **TOL)
    _check_metrics(jm, tm, rtol=TOL["rtol"])


def test_cct2_round_at_default_rates_does_not_depend_on_chunks():
    """At CCT-2's default rates the masks are drawn for all K clients before
    the chunk split, so 1 and 3 chunks run the same round: the same masks,
    and the same math up to the batch size of the vmapped calls (f32,
    ``rtol=1e-5, atol=1e-7``)."""
    spec = build_fns(cct.cct_2_3x2_32())
    assert spec.noise_sites(CCT_B)  # the round draws masks
    params = spec.init(torch.Generator().manual_seed(4))
    cx, cy = (torch.from_numpy(a) for a in _cct_batches(201))
    out = []
    for chunks in (1, 3):
        eng = _cct_engine(spec, params, client_chunks=chunks)
        state, m = eng.run_round(eng.init(params), cx, cy, CLIENT_LR, SERVER_LR, seed=3)
        out.append((eng.last_updates, ravel(state.params, spec.layout), float(m.train_loss)))
    (u1, p1, l1), (u3, p3, l3) = out
    torch.testing.assert_close(u3, u1, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(p3, p1, rtol=1e-5, atol=1e-7)
    assert l3 == pytest.approx(l1, rel=1e-6)
    # another seed draws other masks
    eng = _cct_engine(spec, params)
    eng.run_round(eng.init(params), cx, cy, CLIENT_LR, SERVER_LR, seed=4)
    assert not torch.allclose(eng.last_updates, u1, rtol=1e-3, atol=1e-5)
