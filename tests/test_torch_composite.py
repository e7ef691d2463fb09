"""Composite attacks (``Simulator.register_attackers``) of the port against
the JAX package.

Both packages build ``_CompositeAttack`` from the same entries: label
flipping, sign flipping, noise and ALIE clients, each a ``ByzantineClient``
with its own attack. Held against the JAX package: the branch table and
the three hooks on seeded inputs (``on_batch`` and ``on_grads`` per row,
under ``vmap`` on the JAX side; ``on_updates`` with every attacker reading
the pre-attack matrix and the full byzantine mask and writing its own row),
K=10 MLP rounds in 1 and 3 client chunks, and K=7 MLP streaming rounds in 2
chunks (4 + 3, pad 1), where ``on_updates`` sees one chunk's slab and an
attacker's index names a row of that slab, dropped past its end, as in the
JAX streaming round. The noise attack's normals are the port's (every
callback gets a generator at the round's attack generator's entry state,
as every JAX callback gets the same key), handed to ``jax.random.normal``
in call order. The reference's own row test runs through the port's
``Simulator``.

Tolerances, f32: hooks ``rtol=atol=1e-5``; rounds ``rtol=1e-4, atol=1e-5``
(the variance metrics ``atol=1e-12``), as in ``tests/test_torch_engine.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from blades_tpu.aggregators.trimmedmean import Trimmedmean as JaxTrimmedmean
from blades_tpu.attackers import get_attack as jax_get_attack
from blades_tpu.client import ByzantineClient as JaxByzantineClient
from blades_tpu.core import RoundEngine as JaxRoundEngine
from blades_tpu.models.mlp import create_mnist_model as jax_mlp
from blades_tpu.simulator import _CompositeAttack as JaxComposite
from blades_tpu_torch import Simulator
from blades_tpu_torch.aggregators import Trimmedmean
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.attackers.base import Attack
from blades_tpu_torch.attackers.noise import draw_normals
from blades_tpu_torch.client import ByzantineClient
from blades_tpu_torch.core import RoundEngine, RoundMetrics
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.models import create_mnist_model, params_from_jax
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.simulator import _CompositeAttack
from blades_tpu_torch.utils import rng as port_rng
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

K, F, S, B, D = 10, 4, 2, 8, 59_850
CLIENT_LR, SERVER_LR = 0.1, 1.0
TOL = dict(rtol=1e-5, atol=1e-5)
ROUND_TOL = dict(rtol=1e-4, atol=1e-5)
# (name, kwargs) of each registered attacker, client 0 first
ENTRIES = [("labelflipping", {"num_classes": 10}), ("signflipping", {}),
           ("noise", {"mean": 0.1, "std": 0.2}), ("alie", {"num_clients": K, "num_byzantine": F})]


def _both(entries, k=K):
    """The composite attack in each package, from the same entries, with
    its state for ``k`` clients."""
    ours = _CompositeAttack([(i, ByzantineClient(attack=get_attack(n, **kw)))
                             for i, (n, kw) in enumerate(entries)])
    ref = JaxComposite([(i, JaxByzantineClient(attack=jax_get_attack(n, **kw)))
                        for i, (n, kw) in enumerate(entries)])
    return (ours, ours.init_state(k, D)), (ref, ref.init_state(k, D))


def _queue_normals(monkeypatch, arrays):
    queue = [np.asarray(a) for a in arrays]
    monkeypatch.setattr(jax.random, "normal", lambda *a, **kw: jnp.asarray(queue.pop(0)))
    return queue


# -- the attack itself ---------------------------------------------------------------


def test_branch_table_matches_jax():
    (ours, _), (ref, _) = _both(ENTRIES + [("labelflipping", {"num_classes": 10})])
    np.testing.assert_array_equal(ours._branch_table.numpy(), np.asarray(ref._branch_table))
    # labelflipping and signflipping train dishonestly; each attack object
    # is its own branch, noise and ALIE are honest in training
    assert ours._branch_table.tolist()[:5] == [1, 2, 0, 0, 3]
    assert ours.trains_dishonestly == ref.trains_dishonestly is True
    assert ours.update_locality == getattr(ref, "update_locality", "row") == "row"


def test_on_batch_and_on_grads_dispatch_per_row_as_jax():
    """A chunk of 6 clients (ids 2..7 of K=10, so the label flipper 0 is not
    in it; then ids 0..5): each row takes its own attacker's hook."""
    (ours, _), (ref, _) = _both(ENTRIES + [("labelflipping", {"num_classes": 10})])
    rng = np.random.RandomState(3)
    x = rng.randn(6, B, 5).astype(np.float32)
    y = rng.randint(0, 10, (6, B)).astype(np.int32)
    g = {"w": rng.randn(6, 5, 3).astype(np.float32), "b": rng.randn(6, 3).astype(np.float32)}
    for lo in (2, 0):
        ids = np.arange(lo, lo + 6)
        byz = ids < 5
        tx, ty = ours.on_batch(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(byz),
                               num_classes=10, client_idx=torch.from_numpy(ids))
        jx, jy = jax.vmap(lambda a, b, m, i: ref.on_batch(
            a, b, m, num_classes=10, key=jax.random.PRNGKey(0), client_idx=i))(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(byz), jnp.asarray(ids))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        tg = ours.on_grads({n: torch.from_numpy(a) for n, a in g.items()}, torch.from_numpy(byz),
                           client_idx=torch.from_numpy(ids))
        jg = jax.vmap(lambda gg, m, i: ref.on_grads(gg, m, client_idx=i))(
            {n: jnp.asarray(a) for n, a in g.items()}, jnp.asarray(byz), jnp.asarray(ids))
        for n in g:
            np.testing.assert_array_equal(tg[n].numpy(), np.asarray(jg[n]))
    # rows 0 and 4 flipped labels, row 1 flipped gradients, the rest as given
    assert (ty[[0, 4]] == 9 - torch.from_numpy(y[[0, 4]])).all()
    assert torch.equal(ty[[1, 2, 3, 5]], torch.from_numpy(y[[1, 2, 3, 5]]))
    assert torch.equal(tg["b"][1], -torch.from_numpy(g["b"][1]))


def test_on_updates_matches_jax(monkeypatch):
    """Every attacker reads the pre-attack matrix and the full byzantine
    mask and writes only its own row: row 2 is noise, row 3 ALIE over the
    honest rows 4..9, rows 0, 1 and the honest rows unchanged."""
    (ours, tstate), (ref, jstate) = _both(ENTRIES)
    u = (np.random.RandomState(4).randn(K, D) * 0.01).astype(np.float32)
    byz = np.arange(K) < F
    gen = port_rng.generator(5, 1, port_rng.ATTACK)
    z = draw_normals((K, D), port_rng.generator(5, 1, port_rng.ATTACK), "cpu")
    queue = _queue_normals(monkeypatch, [z])
    got, tstate = ours.on_updates(torch.from_numpy(u), torch.from_numpy(byz), gen, tstate)
    expect, jstate = ref.on_updates(jnp.asarray(u), jnp.asarray(byz), jax.random.PRNGKey(0),
                                    jstate)
    assert queue == []
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    np.testing.assert_array_equal(got[[0, 1, 4, 5, 9]].numpy(), u[[0, 1, 4, 5, 9]])
    torch.testing.assert_close(got[2], 0.1 + 0.2 * z[2])
    assert len(tstate) == len(jstate) == len(ENTRIES)


def test_two_noise_attackers_draw_the_same_normals(monkeypatch):
    """Each callback's generator starts where the round's did, as each JAX
    callback gets the same key: attackers 0 and 1 write rows 0 and 1 of
    one draw; the JAX package, handed that draw for each of its two calls,
    gives the same matrix."""
    entries = [("noise", {"mean": 0.0, "std": 1.0})] * 2
    (ours, tstate), (ref, jstate) = _both(entries)
    u = np.zeros((K, 7), np.float32)
    z = draw_normals((K, 7), port_rng.generator(2, 0, port_rng.ATTACK), "cpu")
    got, _ = ours.on_updates(torch.from_numpy(u), torch.from_numpy(np.arange(K) < 2),
                             port_rng.generator(2, 0, port_rng.ATTACK), tstate)
    torch.testing.assert_close(got[:2], z[:2], rtol=0, atol=0)
    assert not got[2:].any()
    queue = _queue_normals(monkeypatch, [z, z])
    expect, _ = ref.on_updates(jnp.asarray(u), jnp.asarray(np.arange(K) < 2),
                               jax.random.PRNGKey(0), jstate)
    assert queue == []
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


# -- rounds against the JAX engine ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_mlp().init(jax.random.PRNGKey(0)))


def _batches(rnd, k=K):
    rng = np.random.RandomState(500 + rnd)
    cx = rng.randn(k, S, B, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (k, S, B)).astype(np.int32)
    return cx, cy


def _engines(jax_params, entries, k, f, chunks, streaming=False):
    (ours, _), (ref, _) = _both(entries, k)
    jspec, tspec = jax_mlp(), create_mnist_model()
    jeng = JaxRoundEngine(
        jspec.train_loss_fn, jspec.eval_logits_fn, jax_params, num_clients=k,
        num_byzantine=f, attack=ref, aggregator=JaxTrimmedmean(num_byzantine=2), plan=None,
        client_chunks=chunks, keep_updates=not streaming, streaming=streaming,
    )
    tparams = params_from_jax(jax_params, tspec.layout)
    teng = RoundEngine(
        tspec.train_loss_fn, tspec.eval_logits_fn, tparams, tspec.layout, num_clients=k,
        num_byzantine=f, attack=ours, aggregator=Trimmedmean(num_byzantine=2),
        client_chunks=chunks, keep_updates=not streaming, device="cpu", streaming=streaming,
    )
    return (jeng, jeng.init(jax_params)), (teng, teng.init(tparams), tspec.layout)


def _check(j, t, jm, tm):
    (jeng, jstate), (teng, tstate, layout) = j, t
    np.testing.assert_allclose(ravel(tstate.params, layout).numpy(),
                               np.asarray(ravel_pytree(jstate.params)[0]), **ROUND_TOL)
    for name in RoundMetrics._fields:
        atol = 1e-12 if name.startswith("update_variance") else ROUND_TOL["atol"]
        np.testing.assert_allclose(float(getattr(tm, name)), float(getattr(jm, name)),
                                   rtol=ROUND_TOL["rtol"], atol=atol, err_msg=name)


def _round_both(monkeypatch, jeng, jstate, teng, tstate, rnd, seed, k=K, chunk=None):
    """One round of each engine, the port's noise draws queued for JAX:
    the whole ``[K, D]`` draw, or with ``chunk`` (the streaming round) one
    ``[chunk, D]`` draw per chunk from the chunk's generator, once per
    noise attacker, in the order JAX's eager chunk scan asks for them."""
    noise = sum(isinstance(a, type(get_attack("noise"))) for a in teng.attack._attacks)
    if chunk is None:
        draws = [draw_normals((k, D), port_rng.generator(seed, rnd, port_rng.ATTACK), "cpu")]
    else:
        draws = [draw_normals((chunk, D), port_rng.generator(seed, rnd, port_rng.ATTACK,
                                                             chunk=j), "cpu")
                 for j in range(teng.client_chunks)]
    queue = _queue_normals(monkeypatch, [z for z in draws for _ in range(noise)])
    cx, cy = _batches(rnd, k)
    with jax.disable_jit(chunk is not None):
        jstate, jm = jeng.run_round(jstate, jnp.asarray(cx), jnp.asarray(cy), CLIENT_LR,
                                    SERVER_LR, jax.random.PRNGKey(7))
    tstate, tm = teng.run_round(tstate, torch.from_numpy(cx), torch.from_numpy(cy), CLIENT_LR,
                                SERVER_LR, seed=seed)
    assert queue == []  # JAX took every draw, in order
    return jstate, jm, tstate, tm


@pytest.mark.parametrize("chunks", [1, 3])
def test_composite_rounds_match_jax(jax_params, monkeypatch, chunks):
    """Two K=10 MLP rounds, f=4 (a label flipper, a sign flipper, a noise
    client and an ALIE client), trimmed mean b=2: the update matrix, the
    params and the metrics against the JAX engine (a fresh one each round,
    so that its jitted round traces again and takes the round's draw)."""
    (_, jstate), t = _engines(jax_params, ENTRIES, K, F, chunks)
    teng, tstate, layout = t
    for rnd in range(2):
        jeng = _engines(jax_params, ENTRIES, K, F, chunks)[0][0]
        jstate, jm, tstate, tm = _round_both(monkeypatch, jeng, jstate, teng, tstate, rnd, 3)
        tu, ju = teng.last_updates, np.asarray(jeng.last_updates)
        np.testing.assert_allclose(tu.numpy(), ju, **ROUND_TOL)
        _check((jeng, jstate), (teng, tstate, layout), jm, tm)
    # the noise client's row is the noise, ALIE's row its vector
    z = draw_normals((K, D), port_rng.generator(3, 1, port_rng.ATTACK), "cpu")
    torch.testing.assert_close(tu[2], 0.1 + 0.2 * z[2])
    assert not torch.equal(tu[3], tu[4])


@pytest.mark.parametrize("entries", [
    ENTRIES[:3],
    # client 4 lies in chunk 1, at row 0 of that slab; its index 4 is past
    # the end of every 4-row slab, so its noise is dropped, as in JAX
    [ENTRIES[0], ENTRIES[1], ENTRIES[2], ENTRIES[0], ENTRIES[2]],
], ids=["three", "five"])
def test_composite_streaming_rounds_match_jax(jax_params, monkeypatch, entries):
    """Two K=7 MLP streaming rounds of 2 chunks (4 + 3, pad 1), the
    attackers of ``entries`` (row-local: label flipping, sign flipping,
    noise), trimmed mean b=2: on each chunk's slab with the chunk's mask
    and its own generator, against the JAX streaming round."""
    k = 7
    (_, jstate), (teng, tstate, layout) = _engines(jax_params, entries, k, len(entries), 2,
                                                   streaming=True)
    for rnd in range(2):
        jeng = _engines(jax_params, entries, k, len(entries), 2, streaming=True)[0][0]
        jstate, jm, tstate, tm = _round_both(monkeypatch, jeng, jstate, teng, tstate, rnd, 4,
                                             k=k, chunk=teng.chunk_size)
        _check((jeng, jstate), (teng, tstate, layout), jm, tm)
    assert (teng.client_chunks, teng.chunk_size) == (2, 4)


# -- through the Simulator (the reference's row test) --------------------------------


def _sim(tmp_path, name, **kw):
    ds = Synthetic(num_clients=6, train_size=600, test_size=120, noise=0.3, cache=False)
    return Simulator(ds, log_path=str(tmp_path / name), seed=5, device="cpu", **kw)


RUN = dict(global_rounds=1, local_steps=1, train_batch_size=8, validate_interval=1,
           retain_updates=True)


def test_custom_attacker_registration(tmp_path):
    """``tests/test_simulator.py::test_custom_attacker_registration``: two
    attackers whose attack zeroes their rows; ``num_byzantine`` rises to 2,
    their rows and their client handles' updates are zero."""

    class ZeroAttack(Attack):
        def on_updates(self, updates, byz_mask, generator=None, state=()):
            return torch.where(byz_mask[:, None], 0.0, updates), state

    class ZeroClient(ByzantineClient):
        def make_attack(self):
            return ZeroAttack()

    sim = _sim(tmp_path, "zero")
    sim.register_attackers([ZeroClient(), ZeroClient()])
    assert sim.num_byzantine == 2
    sim.run("mlp", **dict(RUN, global_rounds=2, validate_interval=2))
    u = sim.engine.last_updates
    assert not u[:2].any() and u[2:].any()
    assert not sim.get_clients()[0].get_update().any()
    with pytest.raises(ValueError, match="more attackers"):
        sim.register_attackers([ZeroClient() for _ in range(7)])


def test_mixed_custom_attackers_dispatch_per_client(tmp_path):
    """``tests/test_simulator.py::test_mixed_custom_attackers_dispatch_per_client``:
    a label flipper and a sign flipper registered together. Row 0 equals
    the row of a uniform label-flipping run, row 1 is the negation of the
    honest run's row 1 (sign flipping at one local step), the other rows
    are the honest run's."""

    class LFClient(ByzantineClient):
        def make_attack(self):
            return get_attack("labelflipping", num_classes=2)

    class SFClient(ByzantineClient):
        def make_attack(self):
            return get_attack("signflipping")

    honest = _sim(tmp_path, "h")
    honest.run("mlp", **RUN)
    uniform = _sim(tmp_path, "l", num_byzantine=1, attack="labelflipping")
    uniform.run("mlp", **RUN)
    mixed = _sim(tmp_path, "m")
    mixed.register_attackers([LFClient(), SFClient()])
    mixed.run("mlp", **RUN)
    u_h, u_l, u_m = (s.engine.last_updates for s in (honest, uniform, mixed))
    torch.testing.assert_close(u_m[0], u_l[0], rtol=1e-5, atol=1e-7)
    assert not torch.allclose(u_m[0], u_h[0])
    torch.testing.assert_close(u_m[1], -u_h[1], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(u_m[2:], u_h[2:], rtol=1e-6, atol=1e-8)
    assert [c.is_byzantine() for c in mixed.get_clients()] == [True, True] + [False] * 4
