"""``ExperimentBatch(mode="vmap")``: the batched round of S experiments
(``blades_tpu_torch/core/batched.py``) and the trimmed mean's batched
entry (``ops/trimmed.py``).

vmap mode is held to the JAX package's vmap mode (its
``test_vmap_mode_allclose_and_one_program``: the linear model, mean,
shared data) and, for every name of the defense registry, on inputs drawn
once and handed to both (DnC's subspaces: the port's draws handed to
``jax.random.choice``, the JAX round run eagerly under
``jax.disable_jit`` so that each DnC iteration takes its own draw); then
to the port's own map mode on per-experiment data, a fault model, the
streaming round, the static and the general async round, persistent Adam
and the forensics. The bar is ``rtol=1e-5, atol=1e-6`` throughout (on
these inputs the port's vmap and map modes agree bit for bit on the CPU,
which the tests do not require). The ``cuda`` cases hold the batched
launch to S single launches with ``torch.equal`` (one of them past 2^31
elements) and run a captured vmap-mode round on the card; the
``rehearsed`` case runs the graph runner here with the capture replaced by
a Python replay (``tests/test_torch_blocks.py:graph_device``). The JAX
package is imported inside fixtures, so the card cases run where flax is
missing.
"""

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten_with_path

from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator
from blades_tpu_torch.asyncfl import AsyncConfig
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.audit import AuditMonitor
from blades_tpu_torch.core import ClientOptSpec, ExperimentBatch, RoundEngine, unstack_experiments
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.ops import trimmed
from blades_tpu_torch.ops.pytree import FlatLayout, LeafSpec, ravel
from blades_tpu_torch.ops.trimmed import (
    trimmed_mean,
    trimmed_mean_batched,
    trimmed_mean_batched_plain,
    trimmed_mean_plain,
)
from blades_tpu_torch.utils import rng
from test_torch_blocks import SEED, _engine, _fixture, graph_device  # noqa: F401
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

BAR = dict(rtol=1e-5, atol=1e-6)
EK, EF, EC = 6, 12, 4  # the JAX test's linear fixture
LINEAR = FlatLayout((LeafSpec("w", ("w",), (EF, EC)),))


# -- the batched plain trimmed mean and the vmap rule ---------------------------------


def _special_stack():
    """S=3 experiments of [9, 7]: ties, +-0, NaN and +-Inf columns."""
    r = np.random.RandomState(5)
    x = r.randn(3, 9, 7).astype(np.float32)
    x[0, :5, 0] = 1.5  # ties across the trimmed sets
    x[1, :, 1] = 2.0  # an all-equal column
    x[2, ::2, 2], x[2, 1::2, 2] = 0.0, -0.0
    x[0, 3, 3] = np.nan
    x[1, :, 3] = np.nan
    x[2, 4, 4], x[2, 6, 4] = np.inf, -np.inf
    x[0, :3, 5] = np.inf
    x[1, :2, 6], x[1, 2:4, 6] = -np.inf, np.inf
    return torch.from_numpy(x)


def _equal(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("b", [1, 2, 3, 4])
def test_batched_plain_is_the_stack_of_plain(b):
    x = _special_stack()
    want = torch.stack([trimmed_mean_plain(u, b) for u in x])
    assert _equal(trimmed_mean_batched_plain(x, b), want)
    assert _equal(trimmed_mean_batched(x, b), want)  # the CPU route
    # the custom op's vmap rule: one batched call, the same values
    assert _equal(torch.func.vmap(lambda u: trimmed_mean(u, b))(x), want)
    assert _equal(torch.func.vmap(lambda u: trimmed_mean(u, b), in_dims=1)(
        x.transpose(0, 1).contiguous()), want)


def test_vmap_rule_of_nested_and_unbatched_calls():
    x = torch.randn(2, 3, 9, 5, generator=torch.Generator().manual_seed(1))
    got = torch.func.vmap(torch.func.vmap(lambda u: trimmed_mean(u, 2)))(x)
    assert torch.equal(got, torch.stack([trimmed_mean_batched_plain(u, 2) for u in x]))
    # an input the vmapped function closes over is not batched
    y = torch.randn(9, 5, generator=torch.Generator().manual_seed(2))
    out = torch.func.vmap(lambda s: trimmed_mean(y, 2) * s)(torch.ones(3))
    assert torch.equal(out, trimmed_mean_plain(y, 2).expand(3, 5))
    # b = 0 and a b past the kernel's route: the mean and the sort, batched
    assert torch.equal(trimmed_mean_batched(x[0], 0), x[0].mean(dim=1))
    assert torch.allclose(trimmed_mean_batched(x[0], 4), torch.stack(
        [trimmed_mean(u, 4) for u in x[0]]))


# -- against the JAX package -----------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from blades_tpu import aggregators as jaggs
    from blades_tpu.core import ExperimentBatch as JaxExperimentBatch
    from blades_tpu.core import RoundEngine as JaxRoundEngine
    from blades_tpu.datasets.fl import FLDataset as JaxFLDataset

    return dict(jax=jax, jnp=jnp, aggs=jaggs, EB=JaxExperimentBatch, RE=JaxRoundEngine,
                FL=JaxFLDataset)


def _linear_loss(p, x, y, noise):
    logits = x.reshape(x.shape[0], -1) @ p["w"]
    loss = -torch.log_softmax(logits, -1).gather(-1, y.long()[:, None]).mean()
    return loss, {"top1": (logits.argmax(-1) == y).to(torch.float32).mean()}


def _linear_logits(p, x):
    return x.reshape(x.shape[0], -1) @ p["w"]


def _jax_linear(jx, seed):
    """The JAX test's ``_tiny_fixture``: its dataset, W0 and round batch."""
    jax, jnp = jx["jax"], jx["jnp"]
    r = np.random.RandomState(seed)
    ds = jx["FL"](r.randn(EK, 20, EF).astype(np.float32),
                  r.randint(0, EC, (EK, 20)).astype(np.int32), np.full(EK, 20, np.int32),
                  r.randn(30, EF).astype(np.float32), r.randint(0, EC, 30).astype(np.int32))
    w0 = {"w": jnp.asarray(r.randn(EF, EC).astype(np.float32) * 0.1)}

    def loss(p, x, y, key):
        logits = x.reshape(x.shape[0], -1) @ p["w"]
        logp = jax.nn.log_softmax(logits)
        l_ = -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
        return l_, {"top1": jnp.mean((jnp.argmax(logits, -1) == y).astype(jnp.float32))}

    def logits(p, x):
        return x.reshape(x.shape[0], -1) @ p["w"]

    return ds, w0, loss, logits


AGG_KWS = {"trimmedmean": {"num_byzantine": 1}, "krum": {"num_byzantine": 1},
           "multikrum": {"num_byzantine": 1, "num_selected": 3}, "dnc": {"num_byzantine": 1}}


def _both_vmap_rounds(jx, name, monkeypatch, c_lrs=(0.1, 0.2), seed=3):
    """One vmap-mode round of S=2 experiments in each package, the linear
    model on one shared batch; both experiments share a seed (so DnC's
    draws are one list for both) and differ in their learning rates."""
    jax, jnp = jx["jax"], jx["jnp"]
    ds, jw0, jloss, jlogits = _jax_linear(jx, seed)
    key = jax.random.PRNGKey(11)
    cx, cy = ds.sample_round(jax.random.fold_in(key, 1), 1, 4)
    kws = AGG_KWS.get(name, {})
    trusted = np.arange(EK) == EK - 1
    jeng = jx["RE"](jloss, jlogits, jw0, num_clients=EK, num_classes=EC,
                    aggregator=jx["aggs"].get_aggregator(name, **kws),
                    trusted_mask=jnp.asarray(trusted) if name == "fltrust" else None)
    tw0 = {"w": torch.from_numpy(np.asarray(jw0["w"]))}
    teng = RoundEngine(_linear_loss, _linear_logits, tw0, LINEAR, num_clients=EK,
                       num_classes=EC, aggregator=get_aggregator(name, **kws), device="cpu",
                       trusted_mask=torch.from_numpy(trusted) if name == "fltrust" else None)
    s = len(c_lrs)
    tb = ExperimentBatch(teng, s, mode="vmap")
    batch = (torch.from_numpy(np.asarray(cx)), torch.from_numpy(np.asarray(cy)))
    tstates, tms, _ = tb.run_round_batch(tb.init_batch(tw0), *batch, list(c_lrs), [1.0] * s,
                                         [seed] * s, shared_data=True)
    teng.inputs = (tw0, batch, list(c_lrs), seed)
    if name == "dnc":
        from blades_tpu_torch.aggregators.dnc import draw_subspaces

        agg = teng.aggregator
        queue = [a.numpy() for pair in draw_subspaces(rng.generator(seed, 0, rng.AGG),
                                                      agg.num_iters, EF * EC, min(agg.sub_dim, EF * EC),
                                                      "cpu") for a in pair]
        def take(*args, **kwargs):
            return jnp.asarray(queue.pop(0))

        # each iteration's pair, in the order JAX's DnC asks for it
        monkeypatch.setattr(jax.random, "choice", take)
        monkeypatch.setattr(jax.random, "normal", take)
    jb = jx["EB"](jeng, s, mode="vmap")
    args = (jb.init_batch(jw0), cx, cy, jnp.asarray(c_lrs, jnp.float32),
            jnp.ones(s, jnp.float32), jnp.stack([jax.random.PRNGKey(seed)] * s))
    if name == "dnc":
        with jax.disable_jit():
            jstates, jms, _ = jb.run_round_batch(*args, shared_data=True)
        assert queue == []  # the JAX side took every draw
    else:
        jstates, jms, _ = jb.run_round_batch(*args, shared_data=True)
    return teng, tstates, tms, jstates, jms


def test_vmap_mode_allclose_to_jax_and_to_map_mode(jx, monkeypatch):
    """The counterpart of JAX's ``test_vmap_mode_allclose_and_one_program``:
    mean, shared data, S=2 at learning rates 0.1 and 0.2."""
    teng, tstates, tms, jstates, jms = _both_vmap_rounds(jx, "mean", monkeypatch)
    assert teng.last_block_mode == "eager" and "cpu" in teng.last_block_reason
    for s, tst in enumerate(unstack_experiments(tstates)):
        np.testing.assert_allclose(tst.params["w"].numpy(),
                                   np.asarray(jstates.params["w"][s]), **BAR)
        np.testing.assert_allclose(float(tms.train_loss[s]), float(jms.train_loss[s]), **BAR)
    # the port's map mode on the same inputs
    tw0, batch, c_lrs, seed = teng.inputs
    mb = ExperimentBatch(teng, 2, mode="map")
    mstates, mms, _ = mb.run_round_batch(mb.init_batch(tw0), *batch, c_lrs, [1.0, 1.0],
                                         [seed, seed], shared_data=True)
    np.testing.assert_allclose(tstates.params["w"].numpy(), mstates.params["w"].numpy(), **BAR)
    np.testing.assert_allclose(tms.train_loss.numpy(), mms.train_loss.numpy(), **BAR)


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_every_defense_vmap_mode_matches_jax_vmap_mode(jx, monkeypatch, name):
    teng, tstates, tms, jstates, jms = _both_vmap_rounds(jx, name, monkeypatch)
    for s in range(2):
        np.testing.assert_allclose(tstates.params["w"][s].numpy(),
                                   np.asarray(jstates.params["w"][s]), err_msg=name, **BAR)
        for field in ("train_loss", "agg_norm"):
            np.testing.assert_allclose(float(getattr(tms, field)[s]),
                                       float(getattr(jms, field)[s]), err_msg=field, **BAR)
    jleaves = jx["jax"].tree_util.tree_leaves(jstates.agg_state)
    tleaves = [t for _, t in tree_flatten_with_path(tstates.agg_state)[0]
               if isinstance(t, torch.Tensor)]
    if name in ("centeredclipping", "asynccenteredclipping"):
        np.testing.assert_allclose(tleaves[0].numpy(), np.asarray(jleaves[0]), **BAR)


# -- against the port's map mode ----------------------------------------------------------


def _tiny_run(mode, agg="trimmedmean", attack="alie", shared=True, rounds=3, **kw):
    """3 rounds of S=3 experiments (seeds 4-6, client rates 0.1-0.3) on the
    block tests' K=6 linear model with a dropout site (keep-masks drawn
    every step)."""
    ds, w0 = _fixture("cpu")
    kws = {"num_byzantine": 2} if agg in AGG_KWS else {}
    eng = _engine(w0, "cpu", aggregator=get_aggregator(agg, **kws), num_byzantine=2,
                  attack=get_attack(attack), **kw)
    batches = [ds.sample_round(rng.generator(SEED, r, rng.DATA), 2, 4) for r in (1, 2, 3)]
    cx, cy = batches[0] if shared else (torch.stack(p) for p in zip(*batches))
    eb = ExperimentBatch(eng, 3, mode=mode)
    states, outs = eb.init_batch(w0), []
    for _ in range(rounds):
        states, ms, diags = eb.run_round_batch(states, cx, cy, [0.1, 0.2, 0.3],
                                               [1.0, 0.5, 1.0], [4, 5, 6], shared_data=shared)
        outs.append((ms, diags))
    return eng, states, outs


MAP_CASES = {
    "per_experiment_data": dict(shared=False),
    "fault_model": dict(fault_model=FaultModel(dropout_rate=0.3, straggler_rate=0.2,
                                               corrupt_clients=(1,))),
    "streaming": dict(attack="noise", streaming=True, client_chunks=2),
    "streaming_fault": dict(attack="noise", agg="median", streaming=True, client_chunks=2,
                            fault_model=FaultModel(dropout_rate=0.3, corrupt_rate=0.3,
                                                   corrupt_mode="bitflip")),
    "async_static": dict(async_config=AsyncConfig(buffer_m=6)),
    "async_general": dict(async_config=AsyncConfig(
        buffer_m=3, arrivals={"kind": "uniform", "max_delay": 2}, staleness="polynomial")),
    "persist_adam": dict(client_opt=ClientOptSpec(name="adam", persist=True), client_chunks=2),
    "forensics": dict(collect_diagnostics=True, round_metrics=True,
                      audit_monitor=AuditMonitor(fallback_aggregator="median")),
    "dnc_noise": dict(agg="dnc", attack="noise", client_chunks=2),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_vmap_mode_matches_map_mode(case):
    kw = MAP_CASES[case]
    _, mstates, mouts = _tiny_run("map", **kw)
    eng, vstates, vouts = _tiny_run("vmap", **kw)
    assert eng.last_block_mode == "eager"
    mleaves = tree_flatten_with_path((mstates, mouts))[0]
    vleaves = tree_flatten_with_path((vstates, vouts))[0]
    assert [p for p, _ in mleaves] == [p for p, _ in vleaves]
    for (path, a), (_, b) in zip(mleaves, vleaves):
        if isinstance(a, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            np.testing.assert_allclose(b.double().numpy(), a.double().numpy(),
                                       err_msg=str(path), **BAR)
        else:
            assert a == b, path
    if "fault_model" in kw:
        assert vouts[-1][1]["faults"]["participants"].shape == (3,)


def test_vmap_round_makes_one_batched_trimmed_mean_call(monkeypatch):
    """A vmap-mode round with the trimmed mean aggregates the S experiments
    in ONE call of the batched route (on the card one launch); map mode
    takes the single route S times."""
    from blades_tpu_torch.aggregators import trimmedmean

    calls = []
    real_batched, real_single = trimmedmean.trimmed_mean_batched, trimmedmean.trimmed_mean
    monkeypatch.setattr(trimmedmean, "trimmed_mean_batched",
                        lambda u, b: calls.append(("batched", tuple(u.shape))) or real_batched(u, b))
    monkeypatch.setattr(trimmedmean, "trimmed_mean",
                        lambda u, b: calls.append(("single", tuple(u.shape))) or real_single(u, b))
    _tiny_run("vmap", rounds=1)
    assert calls == [("batched", (3, 6, EF * EC))]
    calls.clear()
    _tiny_run("map", rounds=1)
    assert calls == [("single", (6, EF * EC))] * 3


def test_vmap_mode_errors():
    """As the JAX package's ``test_validation_errors``."""
    ds, w0 = _fixture("cpu")
    eng = _engine(w0, "cpu", aggregator=get_aggregator("mean"))
    with pytest.raises(ValueError, match="mode"):
        ExperimentBatch(eng, 2, mode="pmap")
    with pytest.raises(ValueError, match="num_experiments"):
        ExperimentBatch(eng, 0, mode="vmap")
    eb = ExperimentBatch(eng, 2, mode="vmap")
    with pytest.raises(ValueError, match="map"):
        eb.run_block_batch(eb.init_batch(w0), [[1, 1]], [[0.1, 0.1]], [[1.0, 1.0]], [0, 1],
                           sampler=ds.sampler(2, 4))
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA), 2, 4)
    eb6 = ExperimentBatch(eng, 6, mode="vmap")
    with pytest.raises(ValueError, match="ambiguous"):
        eb6.run_round_batch(eb6.init_batch(w0), cx, cy, [0.1] * 6, [1.0] * 6, list(range(6)))
    with pytest.raises(ValueError, match="seeds"):
        eb.run_round_batch(eb.init_batch(w0), cx, cy, [0.1] * 2, [1.0] * 2, [1])
    with pytest.raises(ValueError, match="aggregator"):
        ExperimentBatch(_engine(w0, "cpu"), 2, mode="vmap").run_round_batch(
            eb.init_batch(w0), cx, cy, [0.1] * 2, [1.0] * 2, [0, 1])


# -- the captured batched round ---------------------------------------------------------


def test_captured_vmap_round_equals_the_eager_one(graph_device):  # noqa: F811
    """The batched round of 3 experiments captured (``core/graphs.py:
    BatchRoundGraph``) and replayed equals the eager batched round
    (``core/batched.py:run_batched``) on the same device bit for bit, 3
    rounds (cuDNN deterministic on the card); the kernel's batched entry
    launches once a round, counted once a replay."""
    from blades_tpu_torch.core.batched import batch_inputs, run_batched

    ds, w0 = _fixture(graph_device)
    cx, cy = ds.sample_round(rng.generator(SEED, 1, rng.DATA, device=graph_device), 2, 4)
    lrs, seeds = [0.1, 0.2, 0.3], [4, 5, 6]

    def engine():
        return _engine(w0, graph_device, num_byzantine=2,
                       aggregator=get_aggregator("trimmedmean", num_byzantine=2),
                       attack=get_attack("alie", num_byzantine=2))

    eng = engine()
    eb = ExperimentBatch(eng, 3, mode="vmap")
    states = eb.init_batch(w0)
    before = (trimmed.trimmed_mean_launches, trimmed.trimmed_mean_batched_launches)
    losses = []
    for _ in range(3):
        states, ms, _ = eb.run_round_batch(states, cx, cy, lrs, [1.0] * 3, seeds,
                                           shared_data=True)
        losses.append(ms.train_loss)
    launched = (trimmed.trimmed_mean_launches - before[0],
                trimmed.trimmed_mean_batched_launches - before[1])
    assert eng.last_block_mode == "graph" and eng.last_block_reason is None
    ref_eng = engine()
    ref = ExperimentBatch(ref_eng, 3, mode="vmap").init_batch(w0)
    for r in range(3):
        ref, outs = run_batched(ref_eng, ref, [cx, cy], batch_inputs(ref_eng, lrs, [1.0] * 3, r),
                                rng.StreamStack(seeds, r, graph_device), shared=True)
        assert torch.equal(losses[r], outs[0].train_loss)
    assert states.round_idx == ref.round_idx == 3
    assert torch.equal(states.params["w"], ref.params["w"])
    if graph_device.type == "cuda":
        assert launched == (3, 3)


# -- the batched launch on the card -----------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 10, 257, 2), (8, 1000, 5000, 5), (4, 37, 1000, 16),
                                   (2, 1200, 3000, 4)], ids=str)
def test_batched_launch_equals_single_launches(cuda_device, shape):
    s, k, d, b = shape
    g = torch.Generator(device="cuda").manual_seed(s * k)
    x = torch.randn(s, k, d, generator=g, device="cuda")
    x[:, : b + 1] = x[:, :1]  # ALIE-style ties
    before = (trimmed.trimmed_mean_launches, trimmed.trimmed_mean_batched_launches)
    got = trimmed.trimmed_mean_batched_cuda(x, b)
    assert (trimmed.trimmed_mean_launches, trimmed.trimmed_mean_batched_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, torch.stack([trimmed.trimmed_mean_cuda(u, b) for u in x]))
    torch.testing.assert_close(got, trimmed_mean_batched_plain(x, b), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_batched_launch_past_2_to_the_31(cuda_device):
    """S*K*D = 2 x 100 x 10,800,000 > 2^31 floats (8.6 GB): the 64-bit
    offsets of the experiment axis."""
    s, k, d, b = 2, 100, 10_800_000, 10
    assert s * k * d > 2**31
    x = torch.empty(s, k, d, device="cuda")
    for i in range(s):
        x[i].normal_(generator=torch.Generator(device="cuda").manual_seed(i))
    got = trimmed.trimmed_mean_batched_cuda(x, b)
    for i in range(s):
        assert torch.equal(got[i], trimmed.trimmed_mean_cuda(x[i], b))
    cols = slice(d - 4096, d)  # the far end of the last slab, against the plain version
    torch.testing.assert_close(got[-1, cols], trimmed_mean_plain(x[-1, :, cols], b),
                               rtol=1e-5, atol=1e-5)
