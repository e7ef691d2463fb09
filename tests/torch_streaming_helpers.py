"""Shared inputs, engines and checks of the streaming tests
(``tests/test_torch_streaming*.py``): the registry's streaming split, seeded
matrices, the K=7 MLP streaming engines of both packages, the per-chunk
draws handed to JAX, and the round checks. Not a test module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.core import ClientOptSpec as JaxClientOptSpec
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.attackers.noise import draw_normals
from blades_tpu_torch.core import ClientOptSpec, RoundEngine, RoundMetrics
from blades_tpu_torch.faults import FaultModel, draw_faults
from blades_tpu_torch.models import create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.utils import rng as port_rng


K, D = 7, 33
TOL = dict(rtol=1e-5, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-6)  # GeoMed, AutoGM
ROUND_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)
STREAMING = ("asynccenteredclipping", "asyncmean", "autogm", "centeredclipping",
             "clippedclustering", "clustering", "geomed", "krum", "mean", "median", "multikrum",
             "signguard", "trimmedmean")
OPTOUTS = ("byzantinesgd", "dnc", "fltrust")
# (name, kwargs): every streaming defense, and the variants whose streaming
# form differs (centered clipping's exact n_iter=1, clustering's distance)
CASES = [(n, {"num_byzantine": 2} if n in ("krum", "multikrum", "trimmedmean") else {})
         for n in STREAMING]
CASES += [("centeredclipping", {"n_iter": 1}), ("clustering", {"metric": "distance"}),
          ("multikrum", {"num_byzantine": 1, "num_selected": 3}),
          ("asynccenteredclipping", {"tau": 0.05})]


def _id(case):
    name, kw = case
    return "-".join([name, *(f"{a}{b}" for a, b in kw.items())])


def _tol(name):
    return LOOP_TOL if name in ("geomed", "autogm") else TOL


def _matrix(seed, k=K, d=D):
    return (np.random.RandomState(seed).randn(k, d) * 0.1).astype(np.float32)


def _assert_tree(t, j, tol=TOL):
    """A port state (tensors, dicts, ()) against a JAX state, leaf by leaf."""
    if isinstance(j, dict):
        assert set(t) >= set(j)
        for n in j:
            _assert_tree(t[n], j[n], tol)
        return
    if isinstance(j, tuple) and j == ():
        assert t == ()
        return
    j = np.asarray(j)
    t = t.cpu().numpy()
    assert t.shape == j.shape
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, **tol)
    else:
        np.testing.assert_array_equal(t, j)


MASKS = {"all": None, "two-off": np.array([1, 0, 1, 1, 1, 1, 0], bool),
         "chunk-empty": np.array([0, 0, 0, 0, 1, 1, 1], bool)}
PLAN_CASES = {
    "dropout": dict(dropout_rate=0.4),
    "schedule": dict(participation_schedule=np.array([[1, 0, 1, 1, 0, 1, 1],
                                                      [0, 1, 1, 1, 1, 1, 0]], bool)),
    "corrupt-rate": dict(dropout_rate=0.3, corrupt_rate=0.5),
    "corrupt-clients": dict(dropout_rate=0.3, corrupt_clients=(0, 3, 9)),
    "inf": dict(corrupt_rate=0.5, corrupt_mode="inf"),
    "bitflip": dict(dropout_rate=0.2, corrupt_rate=0.5, corrupt_mode="bitflip"),
    "none": dict(),
}


def _queue_bernoulli(monkeypatch, draws):
    queue = [d.numpy() for d in draws]

    def bernoulli(key, p=0.5, shape=None):
        arr = queue.pop(0)
        assert arr.shape == tuple(shape)
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return queue


S, B = 2, 8
CLIENT_LR, SERVER_LR = 0.1, 1.0
F = 2


def _batches(rnd, k=K):
    rng = np.random.RandomState(300 + rnd)
    cx = rng.randn(k, S, B, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (k, S, B)).astype(np.int32)
    return cx, cy


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _port_engine(params=None, aggregator=("trimmedmean", {"num_byzantine": 2}),
                 attack=("signflipping", {}), faults=None, chunks=2, streaming_on=True,
                 **kw):
    spec = create_mnist_model()
    if params is None:
        params = spec.init(torch.Generator().manual_seed(0))
    return RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout, num_clients=K,
        num_byzantine=F, attack=get_attack(attack[0], **attack[1]),
        aggregator=get_aggregator(aggregator[0], **aggregator[1]), client_chunks=chunks,
        device="cpu", fault_model=None if faults is None else FaultModel(**faults),
        streaming=streaming_on, **kw,
    ), params


def _stream_engines(jax_params, aggregator, attack, faults, chunks=2, client_opt=None):
    jspec, tspec = jax_mlp(), create_mnist_model()
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jax_params, num_clients=K,
        num_byzantine=F, attack=jax_get_attack(attack[0], **attack[1]),
        aggregator=jax_get_aggregator(aggregator[0], **aggregator[1]), plan=None,
        client_chunks=chunks, streaming=True,
        fault_model=None if faults is None else JaxFaultModel(**faults),
        client_opt=JaxClientOptSpec(**(client_opt or {})),
    )
    tparams = params_from_jax(jax_params, tspec.layout)
    teng, _ = _port_engine(tparams, aggregator, attack, faults, chunks,
                           client_opt=ClientOptSpec(**(client_opt or {})))
    return (jeng, jeng.init(jax_params)), (teng, teng.init(tparams), tspec.layout)


def _chunk_draws(teng, seed, rnd):
    """The port's per-chunk draws of round ``rnd``: the noise attack's
    normals and the bit-flip patterns, in the order JAX's eager chunk scan
    asks for them; and the fault plan's [K] draws."""
    normals, flips = [], []
    shape = (teng.chunk_size, teng.dim)
    for j in range(teng.client_chunks):
        if type(teng.attack).__name__ == "Noise":
            normals.append(draw_normals(
                shape, port_rng.generator(seed, rnd, port_rng.ATTACK, chunk=j), "cpu"))
        if teng.fault_model is not None and teng.fault_model.corrupt_mode == "bitflip":
            flips.append(torch.empty(shape, dtype=torch.bool).bernoulli_(
                teng.fault_model.bitflip_frac,
                generator=port_rng.generator(seed, rnd, port_rng.FAULT, chunk=j)))
    plan = []
    if teng.fault_model is not None:
        plan = [d for d in draw_faults(teng.fault_model, K, None, port_rng.generator(
            seed, rnd, port_rng.FAULT)).values() if d is not None]
    return normals, plan + flips


def _run_both(monkeypatch, j, t, rnd, seed=0, steps=None):
    (jeng, jstate), (teng, tstate, layout) = j, t
    normals, bern = _chunk_draws(teng, seed, rnd)
    nq = [a.numpy() for a in normals]
    bq = _queue_bernoulli(monkeypatch, bern)
    monkeypatch.setattr(jax.random, "normal", lambda *a, **kw: jnp.asarray(nq.pop(0)))
    cx, cy = (a[:, :steps] for a in _batches(rnd))
    eager = bool(normals) or any(b.dim() == 2 for b in bern)
    with jax.disable_jit(eager):
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy), CLIENT_LR,
                                SERVER_LR, seed=seed)
    assert nq == [] and bq == []  # JAX took every draw, in order
    return (jeng, jstate), (teng, tstate, layout), jm, tm


def _check_round(j, t, jm, tm, tol=ROUND_TOL):
    (jeng, jstate), (teng, tstate, layout) = j, t
    np.testing.assert_allclose(ravel(tstate.params, layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **tol)
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else tol["atol"]
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=tol["rtol"], atol=atol, err_msg=name)
    if jeng.fault_model is not None:
        assert {n: int(v) for n, v in teng.last_fault_diag.items()} == {
            n: int(v) for n, v in jeng.last_fault_diag.items()}
    else:
        assert teng.last_fault_diag is None
    assert teng.last_updates is None
    _assert_tree(tstate.agg_state, jstate.agg_state, tol)


FAULT_CASES = {
    "none": None,
    "nan": dict(dropout_rate=0.3, corrupt_clients=(1, 4)),
    # the default 2^15 bit-flip scale would multiply the two frameworks'
    # rounding differences in a flipped survivor past ROUND_TOL; the draws
    # and masks are what this holds, and test_plan_streaming_... holds the
    # default scale bit for bit
    "bitflip": dict(dropout_rate=0.2, corrupt_rate=0.4, corrupt_mode="bitflip",
                    bitflip_scale=2.0),
}
ATTACKS = [("signflipping", {}), ("labelflipping", {"num_classes": 10}), ("noise", {})]
CCT_K, CCT_F, CCT_B = 6, 2, 4
NO_NOISE = dict(attention_dropout=0.0, stochastic_depth=0.0)
