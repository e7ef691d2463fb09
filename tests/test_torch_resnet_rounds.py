"""Rounds of the port's narrow ResNet-18 twin (``ResNet((2, 2, 2, 2),
width=8)``, D = 176,402 at 32x32x3) against ``blades_tpu.core.RoundEngine``:
a K=6 dense round under ALIE with trimmed mean b=2, and a K=7 streaming
round of 3 chunks (3 + 3 + 1, pad 2) under sign flipping with the median,
at CIFAR's 32x32x3 and MNIST's 28x28x1. Params from the flax init, the
batches seeded numpy arrays handed to both; the update matrix, the new
params and the metrics within ``rtol=1e-4, atol=1e-5`` (the rounds' bar of
``tests/test_torch_engine.py``). The model draws nothing in training, so
no draws are handed across. The vmapped client step runs with torch's
batching-rule fallback warning turned into an error.
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
from blades_tpu.models import resnet as jax_resnet
from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.core import RoundEngine, RoundMetrics
from blades_tpu_torch.models import build_fns, params_from_jax, resnet
from blades_tpu_torch.ops.pytree import ravel
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
F, S, B = 2, 1, 4
CLIENT_LR, SERVER_LR = 0.1, 1.0
CASES = {
    "dense-alie-trimmedmean": dict(k=6, attack="alie", aggregator=("trimmedmean",
                                                                   {"num_byzantine": 2})),
    "streaming-signflipping-median": dict(k=7, attack="signflipping",
                                          aggregator=("median", {}), streaming=True,
                                          client_chunks=3),
}


@pytest.mark.filterwarnings(
    "error:.*performance drop because we have not yet implemented the batching rule")
@pytest.mark.parametrize("shape", [(32, 32, 3), (28, 28, 1)], ids=["32x32x3", "28x28x1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_resnet_round_matches_jax(case, shape):
    c = CASES[case]
    k, streaming, chunks = c["k"], c.get("streaming", False), c.get("client_chunks", 1)
    jspec = jax_build_fns(jax_resnet.ResNet(stage_sizes=(2, 2, 2, 2), width=8), shape)
    jparams = jax.tree_util.tree_map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    tspec = build_fns(resnet.ResNet((2, 2, 2, 2), width=8, in_channels=shape[-1]))
    tparams = params_from_jax(jparams, tspec.layout)
    attack_kws = dict(num_clients=k, num_byzantine=F) if c["attack"] == "alie" else {}
    name, kws = c["aggregator"]
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jparams, num_clients=k, num_byzantine=F,
        attack=jax_get_attack(c["attack"], **attack_kws),
        aggregator=jax_get_aggregator(name, **kws), plan=None, client_chunks=chunks,
        streaming=streaming, keep_updates=not streaming,
    )
    teng = RoundEngine(
        tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout, num_clients=k,
        num_byzantine=F, attack=get_attack(c["attack"], **attack_kws),
        aggregator=get_aggregator(name, **kws), client_chunks=chunks, device="cpu",
        noise_sites=tspec.noise_sites, streaming=streaming,
    )
    assert (teng.client_chunks, teng.chunk_size) == (jeng.client_chunks, jeng.chunk_size)
    r = np.random.RandomState(300)
    cx = r.randn(k, S, B, *shape).astype(np.float32)
    cy = r.randint(0, 10, (k, S, B)).astype(np.int32)
    jstate, jm = jeng.run_round(jeng.init(jparams), jnp.asarray(cx), jnp.asarray(cy),
                                CLIENT_LR, SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(teng.init(tparams), torch.from_numpy(cx),
                                torch.from_numpy(cy), CLIENT_LR, SERVER_LR)
    if not streaming:
        assert teng.last_updates.shape == (k, 176_402 if shape[-1] == 3 else 176_258)
        np.testing.assert_allclose(teng.last_updates.numpy(), np.asarray(jeng.last_updates),
                                   **TOL)
    np.testing.assert_allclose(ravel(tstate.params, tspec.layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **TOL)
    for field in RoundMetrics._fields:
        atol = 1e-12 if field.startswith("update_variance") else TOL["atol"]
        np.testing.assert_allclose(float(getattr(tm, field)), float(getattr(jm, field)),
                                   rtol=TOL["rtol"], atol=atol, err_msg=field)
