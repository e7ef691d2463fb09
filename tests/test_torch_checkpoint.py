"""Checkpoint and resume of the port (``utils/checkpoint.py``,
``Simulator.run(checkpoint_path=, checkpoint_interval=, resume=)``), as
``tests/test_checkpoint.py`` holds the JAX package's: the round trip,
atomic saves, clean errors on a torn or mismatched archive, owned copies,
bf16 and host leaves; and resume bit for bit, per round, at a block
boundary, after a crash autosave under the fault model with a non-empty
straggler buffer, under async with a non-empty buffer, and with
persistent client state. Everything runs on the CPU (eager blocks);
``tests/test_torch_blocks.py`` has the card's cases. The file imports
nothing of JAX."""

import os

import numpy as np
import pytest
import torch

from blades_tpu_torch import Simulator
from blades_tpu_torch.core import ClientOptSpec, RoundEngine, RoundState
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.utils import checkpoint
from blades_tpu_torch.utils.checkpoint import (
    RESUME_ENV,
    checkpoint_file,
    restore_state,
    save_state,
)
from blades_tpu_torch.utils.logging import read_stats


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.zeros(4), torch.tensor(3, dtype=torch.int32), 7, None)}


def _zeros_like(tree):
    return torch.utils._pytree.tree_map(
        lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else t, tree)


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    out = restore_state(p, _zeros_like(tree))
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"][0], tree["b"][0])
    assert int(out["b"][1]) == 3 and out["b"][1].dtype == torch.int32
    assert out["b"][2] == 7 and type(out["b"][2]) is int and out["b"][3] is None


def test_checkpoint_file_appends_npz(tmp_path):
    assert checkpoint_file("a/b") == "a/b.npz" and checkpoint_file("a/b.npz") == "a/b.npz"
    save_state(str(tmp_path / "bare"), _tree())
    assert os.listdir(tmp_path) == ["bare.npz"]


def test_save_is_atomic_no_tmp_left_behind(tmp_path):
    tree = {"a": torch.arange(4.0)}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    save_state(p, tree)  # replace over an existing checkpoint
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert torch.equal(restore_state(p, {"a": torch.zeros(4)})["a"], tree["a"])


def test_failed_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    """A save that fails between writing ``<path>.tmp`` and ``os.replace``
    removes the temp file and leaves the earlier checkpoint intact."""
    p = str(tmp_path / "ck.npz")
    save_state(p, {"a": torch.arange(4.0)})

    def boom(src, dst):
        assert os.path.exists(src) and src == p + ".tmp"
        raise OSError("disk gone")

    monkeypatch.setattr(checkpoint.os, "replace", boom)
    with pytest.raises(OSError, match="disk gone"):
        save_state(p, {"a": torch.full((4,), 9.0)})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["ck.npz"]
    assert torch.equal(restore_state(p, {"a": torch.zeros(4)})["a"], torch.arange(4.0))


@pytest.mark.parametrize("cut", ["half", "ten_bytes", "tail"])
def test_truncated_checkpoint_raises_clean_error(tmp_path, cut):
    tree = {"a": torch.arange(64.0), "b": torch.zeros(8, 8)}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    raw = open(p, "rb").read()
    n = {"half": len(raw) // 2, "ten_bytes": 10, "tail": len(raw) - 30}[cut]
    with open(p, "wb") as f:
        f.write(raw[:n])
    with pytest.raises(ValueError, match="corrupt or unreadable") as err:
        restore_state(p, _zeros_like(tree))
    assert p in str(err.value)


@pytest.mark.parametrize("like,match", [
    ({"a": torch.zeros(2, 3)}, "leaves"),
    ({"a": torch.zeros(2, 3), "c": (torch.zeros(4), torch.zeros((), dtype=torch.int32), 0,
                                    None)}, "tree structure"),
    ({"a": torch.zeros(3, 2), "b": (torch.zeros(4), torch.zeros((), dtype=torch.int32), 0,
                                    None)}, "shape"),
    ({"a": torch.zeros(2, 3, dtype=torch.float64),
      "b": (torch.zeros(4), torch.zeros((), dtype=torch.int32), 0, None)}, "dtype"),
    ({"a": torch.zeros(2, 3), "b": (torch.zeros(4), torch.zeros((), dtype=torch.int32), 0.5,
                                    None)}, "expected float"),
], ids=["leaf_count", "tree", "shape", "dtype", "host_kind"])
def test_mismatched_state_raises_clean_error(tmp_path, like, match):
    p = str(tmp_path / "ck")
    save_state(p, _tree())
    with pytest.raises(ValueError, match=match):
        restore_state(p, like)


def test_restored_leaves_are_owned_copies(tmp_path):
    """Restored tensors own their memory: writing one in place (a captured
    round writes its state back so) and churning the heap leaves a second
    restore, and the values, as saved."""
    src = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=50_000)
                                 .astype(np.float32))}
    p = str(tmp_path / "ck")
    save_state(p, src)
    a, b = restore_state(p, src)["w"], restore_state(p, src)["w"]
    assert a.data_ptr() != b.data_ptr() and a.is_contiguous() and a._base is None
    want = src["w"].clone()
    b.mul_(1.0)
    for _ in range(16):  # heap churn over any freed pages
        np.full(50_000, np.nan, np.float32)
    a.add_(1.0)
    assert torch.equal(b, want) and torch.equal(a, want + 1.0)
    assert torch.equal(restore_state(p, src)["w"], want)


def test_bfloat16_leaf_round_trips_bit_for_bit(tmp_path):
    bits = torch.from_numpy(np.random.default_rng(1).integers(-2**15, 2**15, 1000,
                                                              dtype=np.int16))
    tree = {"h": bits.view(torch.bfloat16), "f": torch.randn(5)}
    p = str(tmp_path / "ck")
    save_state(p, tree)
    out = restore_state(p, _zeros_like(tree))
    assert out["h"].dtype == torch.bfloat16
    assert torch.equal(out["h"].view(torch.int16), bits)  # NaN payloads included


def test_round_state_round_trips_from_an_engine_init(tmp_path):
    """A state after rounds restores into a fresh engine's init state: the
    same tree (key order included), ``round_idx`` a host int."""
    sim = _sim(tmp_path, "a")
    sim.run("mlp", **RUN, fault_model=FAULTS, client_optimizer=ClientOptSpec(
        name="sgd", momentum=0.9, persist=True))
    st = sim.server.state
    p = str(tmp_path / "ck")
    save_state(p, st)
    like = sim.engine.init({n: torch.zeros_like(t) for n, t in st.params.items()})
    out = restore_state(p, like)
    assert isinstance(out, RoundState) and out.round_idx == 4 and type(out.round_idx) is int
    _assert_states_equal(out, st)


# -- Simulator resume ----------------------------------------------------------------------

RUN = dict(global_rounds=4, local_steps=1, train_batch_size=8, validate_interval=100)
FAULTS = dict(dropout_rate=0.3, straggler_rate=0.4, max_staleness=2, corrupt_clients=(1,))


def _sim(tmp_path, tag, aggregator="trimmedmean", **kw):
    ds = Synthetic(num_clients=6, train_size=240, test_size=60, cache=False)
    return Simulator(ds, attack="alie", num_byzantine=2, aggregator=aggregator,
                     aggregator_kws={"num_byzantine": 1} if aggregator == "trimmedmean" else {},
                     seed=5, device="cpu", log_path=str(tmp_path / tag), **kw)


def _leaves(tree):
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _assert_states_equal(a, b):
    assert a.round_idx == b.round_idx
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            assert torch.equal(torch.isnan(x), torch.isnan(y))
            x, y = torch.nan_to_num(x), torch.nan_to_num(y)
        assert torch.equal(x, y)


def _train(tag_dir):
    return [(r["Round"], r["Loss"], r["top1"]) for r in read_stats(str(tag_dir), "train")]


def test_simulator_resume_bit_exact(tmp_path):
    ref = _sim(tmp_path, "ref")
    ref.run("mlp", **RUN)
    ck = str(tmp_path / "state.npz")
    first = _sim(tmp_path, "first")
    first.run("mlp", **dict(RUN, global_rounds=2), checkpoint_path=ck, checkpoint_interval=2)
    assert os.path.exists(ck) and not os.path.exists(ck + ".tmp")
    rest = _sim(tmp_path, "rest")
    times = rest.run("mlp", **RUN, checkpoint_path=ck, resume=True)
    assert len(times) == 2  # rounds 3 and 4 only
    _assert_states_equal(ref.server.state, rest.server.state)
    assert _train(tmp_path / "ref")[2:] == _train(tmp_path / "rest")
    assert os.path.exists(ck)  # a user's checkpoint is never removed


def test_checkpoint_interval_saves_every_nth_round(tmp_path, monkeypatch):
    import blades_tpu_torch.simulator as simulator_mod

    saved = []

    def spy(path, state):
        saved.append(state.round_idx)
        save_state(path, state)

    monkeypatch.setattr(simulator_mod, "save_state", spy)
    _sim(tmp_path, "a").run("mlp", **dict(RUN, global_rounds=5),
                            checkpoint_path=str(tmp_path / "ck"), checkpoint_interval=2)
    saved.append("blocks")
    blocked = _sim(tmp_path, "b")
    blocked.run("mlp", **dict(RUN, global_rounds=7), block_size=3,
                checkpoint_path=str(tmp_path / "ck2"), checkpoint_interval=2)
    # per round: after rounds 2 and 4; in blocks of 3: after each block
    # holding an even round (1-3, 4-6), a boundary state, not the remainder
    assert saved == [2, 4, "blocks", 3, 6]
    assert restore_state(str(tmp_path / "ck2"), blocked.server.state).round_idx == 6


@pytest.mark.parametrize("block_size", [2, 4])
def test_block_boundary_resume_bit_exact(tmp_path, block_size):
    """Blocks (eager here) checkpoint block-boundary states; a run stopped
    at a boundary and resumed in blocks lands on the per-round run."""
    seq = _sim(tmp_path, "seq")
    seq.run("mlp", **dict(RUN, global_rounds=6))
    ck = str(tmp_path / "blk.npz")
    first = _sim(tmp_path, "first")
    first.run("mlp", **dict(RUN, global_rounds=4), block_size=block_size, checkpoint_path=ck,
              checkpoint_interval=4)
    assert first.server.state.round_idx == 4
    rest = _sim(tmp_path, "rest")
    rest.run("mlp", **dict(RUN, global_rounds=6), block_size=block_size, checkpoint_path=ck,
             resume=True)
    _assert_states_equal(seq.server.state, rest.server.state)
    assert _train(tmp_path / "seq")[4:] == _train(tmp_path / "rest")


def _crash_at(rnd_to_fail):
    def boom(rnd, state, m):
        if rnd == rnd_to_fail:
            raise RuntimeError("simulated kill")
    return boom


def _crash_resume(tmp_path, **run_kw):
    """An uninterrupted 4-round run, and the same run killed after round 2
    (the crash autosave fires) and resumed by a fresh Simulator on the same
    log dir; returns both Simulators and the autosaved state's round."""
    ref = _sim(tmp_path, "ref")
    ref.run("mlp", **RUN, **run_kw)
    crashed = _sim(tmp_path, "b")
    with pytest.raises(RuntimeError, match="simulated kill"):
        crashed.run("mlp", **RUN, on_round_end=_crash_at(2), **run_kw)
    autosave = tmp_path / "b" / "autosave.npz"
    assert autosave.exists() and not (tmp_path / "b" / "autosave.npz.tmp").exists()
    saved = crashed.server.state
    resumed = _sim(tmp_path, "b")  # the log dir's wipe keeps *.npz
    assert autosave.exists()
    times = resumed.run("mlp", **RUN, resume=True, **run_kw)
    assert len(times) == 2
    _assert_states_equal(ref.server.state, resumed.server.state)
    assert _train(tmp_path / "ref")[2:] == _train(tmp_path / "b")
    assert not autosave.exists()  # a completed run removes its implicit autosave
    return ref, saved, resumed


def test_crash_autosave_resume_bit_exact_under_faults(tmp_path):
    _, saved, resumed = _crash_resume(tmp_path, fault_model=FAULTS)
    # a straggler buffer holding updates rides the checkpoint
    assert saved.round_idx == 2 and bool(saved.fault_state["has"].any())
    assert float(saved.fault_state["stale"].abs().sum()) > 0
    assert resumed.engine.last_fault_diag is not None


def test_crash_autosave_resume_bit_exact_with_a_participation_schedule(tmp_path):
    """The schedule's row is picked from the device round index, which a
    resumed run rebuilds from the restored ``round_idx``: rounds 3 and 4
    take rows 2 and 0 of a period-3 schedule, as uninterrupted."""
    sched = [[True] * 6, [False, True] * 3, [True, False] * 3]
    _, saved, resumed = _crash_resume(tmp_path, fault_model={
        "participation_schedule": sched, "straggler_rate": 0.5, "max_staleness": 2})
    assert saved.round_idx == 2
    assert int(resumed.engine.last_fault_diag["participants"]) <= 6


def test_crash_autosave_resume_bit_exact_under_async(tmp_path):
    cfg = {"buffer_m": 4, "arrivals": {"kind": "fixed", "delays": (0, 1, 2, 3, 1, 2)},
           "staleness": "polynomial"}
    _, saved, _ = _crash_resume(tmp_path, async_config=cfg)
    # updates sit in the buffer, unfired, when the crash lands
    assert bool(saved.async_state["buf_mask"].any())
    assert float(saved.async_state["buf"].abs().sum()) > 0


def test_crash_autosave_resume_bit_exact_with_persistent_client_state(tmp_path):
    _, saved, _ = _crash_resume(tmp_path, client_optimizer=ClientOptSpec(
        name="sgd", momentum=0.9, persist=True))
    assert _leaves(saved.client_opt_state) and any(
        bool(t.abs().sum() > 0) for t in _leaves(saved.client_opt_state))


def test_crash_between_blocks_saves_the_last_boundary(tmp_path, monkeypatch):
    """A failure in the second block: the autosave holds the first block's
    state (the server's state is set only once a block returns), and a
    resumed run in blocks lands on the uninterrupted one."""
    seq = _sim(tmp_path, "seq")
    seq.run("mlp", **dict(RUN, global_rounds=6))
    calls, real = [], RoundEngine.run_block

    def flaky(self, *args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("lost the device mid-block")
        return real(self, *args, **kw)

    monkeypatch.setattr(RoundEngine, "run_block", flaky)
    sim = _sim(tmp_path, "b")
    with pytest.raises(RuntimeError, match="mid-block"):
        sim.run("mlp", **dict(RUN, global_rounds=6), block_size=3)
    monkeypatch.undo()
    assert sim.server.state.round_idx == 3
    assert restore_state(str(tmp_path / "b" / "autosave"), sim.server.state).round_idx == 3
    resumed = _sim(tmp_path, "b")
    assert len(resumed.run("mlp", **dict(RUN, global_rounds=6), block_size=3,
                           resume=True)) == 3
    _assert_states_equal(seq.server.state, resumed.server.state)


def test_autosave_failure_does_not_mask_the_error(tmp_path, monkeypatch):
    import blades_tpu_torch.simulator as simulator_mod

    def broken(path, state):
        raise OSError("read-only file system")

    monkeypatch.setattr(simulator_mod, "save_state", broken)
    sim = _sim(tmp_path, "a")
    with pytest.raises(RuntimeError, match="simulated kill"):
        sim.run("mlp", **RUN, on_round_end=_crash_at(1))
    debug = (tmp_path / "a" / "debug").read_text()
    assert "crash autosave failed" in debug and "read-only" in debug


def test_fresh_run_removes_a_stale_implicit_autosave_and_keeps_a_user_checkpoint(tmp_path):
    crashed = _sim(tmp_path, "b")
    with pytest.raises(RuntimeError):
        crashed.run("mlp", **RUN, on_round_end=_crash_at(2))
    autosave = tmp_path / "b" / "autosave.npz"
    assert autosave.exists()
    seen = {}

    def probe(rnd, state, m):
        if rnd == 1:
            seen["at_round_1"] = autosave.exists()

    fresh = _sim(tmp_path, "b")
    fresh.run("mlp", **dict(RUN, global_rounds=1), on_round_end=probe)
    assert seen == {"at_round_1": False}  # removed before the first round

    ck = tmp_path / "user.npz"
    user = _sim(tmp_path, "c")
    user.run("mlp", **dict(RUN, global_rounds=2), checkpoint_path=str(ck),
             checkpoint_interval=1)
    again = _sim(tmp_path, "c")
    again.run("mlp", **dict(RUN, global_rounds=1), checkpoint_path=str(ck))
    assert ck.exists()
    assert restore_state(str(ck), again.server.state).round_idx == 2


def test_blades_resume_env_resumes(tmp_path, monkeypatch):
    ref = _sim(tmp_path, "ref")
    ref.run("mlp", **RUN)
    crashed = _sim(tmp_path, "b")
    with pytest.raises(RuntimeError):
        crashed.run("mlp", **RUN, on_round_end=_crash_at(3))
    monkeypatch.setenv(RESUME_ENV, "1")
    resumed = _sim(tmp_path, "b")
    assert len(resumed.run("mlp", **RUN)) == 1
    _assert_states_equal(ref.server.state, resumed.server.state)


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    ref = _sim(tmp_path, "ref")
    ref.run("mlp", **RUN)
    sim = _sim(tmp_path, "b")
    assert len(sim.run("mlp", **RUN, resume=True, checkpoint_path=str(tmp_path / "none"))) == 4
    _assert_states_equal(ref.server.state, sim.server.state)
