"""The seeded chaos suite (``examples/chaos.py``) against the JAX package's
(``scripts/chaos.py``).

Each scenario is a function of its seed, drawn with numpy: the port's
equals the JAX package's for seeds 0-23. The invariants hold on the CPU
for a few seeds: a dropout scenario and a whole-row NaN one (seeds 1 and
3), the NaN <-> Inf inertness twin of seed 1 (bit-identical final
parameters), the async seed 5 and the block rerun of seeds 1 and 5. The
sweep killed by the journal's saboteur resumes to a complete result set.
The full 24-scenario sweep and the supervised SIGKILL child are ``slow``,
as in ``tests/test_chaos.py``.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from blades_tpu_torch.examples import chaos
from blades_tpu_torch.sweeps.journal import KILL_AT_ENV
from blades_tpu_torch.telemetry.schema import validate_records
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_chaos", os.path.join(ROOT, "scripts",
                                                                          "chaos.py"))
jax_chaos = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_chaos)

TIER1_SEEDS = (1, 3)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "BLADES_RESUME", KILL_AT_ENV)}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(worker_threads()), **extra)
    return env


def test_scenarios_equal_jax_and_serialize():
    assert chaos.AGG_POOL == jax_chaos.AGG_POOL
    assert chaos.ATTACK_POOL == jax_chaos.ATTACK_POOL
    assert (chaos.NUM_CLIENTS, chaos.ROUNDS) == (jax_chaos.NUM_CLIENTS, jax_chaos.ROUNDS)
    for seed in range(24):
        scn = chaos.make_scenario(seed)
        assert scn == jax_chaos.make_scenario(seed) == chaos.make_scenario(seed)
        assert json.loads(json.dumps(scn)) == scn
        assert chaos.inertness_variant(scn) == jax_chaos.inertness_variant(scn)


def test_sweep_covers_every_pool_aggregator():
    aggs = {chaos.make_scenario(s)["agg"] for s in range(24)}
    assert aggs == set(chaos.AGG_POOL)
    assert len(chaos.AGG_POOL) + 6 <= 24


def test_inertness_twin_only_for_whole_row_corruption():
    for seed in range(24):
        scn = chaos.make_scenario(seed)
        twin = chaos.inertness_variant(scn)
        mode = scn["fault"].get("corrupt_mode")
        if mode in ("nan", "inf"):
            assert twin["fault"]["corrupt_mode"] != mode
            assert {k: v for k, v in twin.items() if k != "fault"} == {
                k: v for k, v in scn.items() if k != "fault"}
        else:
            assert twin is None


@pytest.mark.parametrize("seed", TIER1_SEEDS)
def test_scenario_invariants_tier1(seed, tmp_path):
    scn = chaos.make_scenario(seed)
    log = str(tmp_path / f"s{seed}")
    sim, params = chaos.run_scenario(scn, log, device="cpu")
    assert chaos.check_invariants(scn, log, params) == []
    assert torch.isfinite(torch.tensor(sim.evaluate(scn["rounds"], 64)["Loss"]))
    records = [json.loads(line) for line in open(os.path.join(log, "telemetry.jsonl"))]
    assert validate_records(records) == []
    assert chaos.max_dev_ratio(log) is not None


def test_inertness_twin_bit_identical_tier1(tmp_path):
    scn = chaos.make_scenario(1)
    assert scn["fault"]["corrupt_mode"] == "nan"
    twin = chaos.inertness_variant(scn)
    _, p_nan = chaos.run_scenario(scn, str(tmp_path / "nan"), device="cpu")
    _, p_inf = chaos.run_scenario(twin, str(tmp_path / "inf"), device="cpu")
    assert torch.equal(p_nan, p_inf)


def test_async_scenario_invariants_tier1(tmp_path):
    scn = chaos.make_scenario(5)
    assert scn.get("async") is not None and "straggler_rate" not in scn["fault"]
    log = str(tmp_path / "s5")
    sim, params = chaos.run_scenario(scn, log, device="cpu")
    assert chaos.check_invariants(scn, log, params) == []
    _, p_blk = chaos.run_scenario(scn, str(tmp_path / "blk"), block_size=2, device="cpu")
    assert torch.equal(params, p_blk)


def test_block_scheduling_neutral_under_faults_tier1(tmp_path):
    scn = chaos.make_scenario(1)
    _, p_seq = chaos.run_scenario(scn, str(tmp_path / "seq"), device="cpu")
    _, p_blk = chaos.run_scenario(scn, str(tmp_path / "blk"), block_size=2, device="cpu")
    assert torch.equal(p_seq, p_blk)


def test_the_service_part_raises_naming_slice_13b(tmp_path):
    with pytest.raises(NotImplementedError, match="slice 13b"):
        chaos.service_chaos(str(tmp_path))
    for flag in (["--via-service", "sock"], ["--service", "reduced"]):
        with pytest.raises(NotImplementedError, match="slice 13b"):
            chaos.main(flag + ["--out", str(tmp_path)])


def _chaos(argv, env, timeout=420):
    return subprocess.run([sys.executable, "-m", "blades_tpu_torch.examples.chaos", *argv],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=timeout)


def test_chaos_kill_mid_sweep_resume_tier1(tmp_path):
    """SIGKILLed after its first journaled seed, the sweep relaunched under
    ``BLADES_RESUME=1`` recovers that seed, runs only the other, and ends
    with zero violations and both seeds' rows."""
    out = tmp_path / "sweep"
    env = _env(BLADES_LEDGER=str(tmp_path / "ledger.jsonl"))
    argv = ["--sweep", "2", "--device", "cpu", "--out", str(out)]
    killed = _chaos(argv, dict(env, **{KILL_AT_ENV: "1"}))
    assert killed.returncode == -signal.SIGKILL, (killed.stdout, killed.stderr)
    journal = [json.loads(line) for line in open(out / "sweep_journal.jsonl") if line.strip()]
    assert sum(r.get("kind") == "cell" for r in journal) == 1
    resumed = _chaos(argv, dict(env, BLADES_RESUME="1"))
    assert resumed.returncode == 0, (resumed.stdout, resumed.stderr)
    res = json.loads(resumed.stdout.splitlines()[-1])
    assert res["ok"] is True and res["resumed"] is True and res["resumed_skipped"] == 1
    assert res["scenarios"] == 2 and [r["seed"] for r in res["results"]] == [0, 1]
    assert res["violations"] == [] and res["quarantined_cells"] == []
    records = [json.loads(line) for line in open(out / "sweep_trace.jsonl") if line.strip()]
    at = max(i for i, r in enumerate(records) if r.get("t") == "resume")
    ran = [r for r in records[at:] if r.get("t") == "sweep" and r.get("i") and not r.get("resumed")]
    assert len(ran) == 1
    assert validate_records(records) == []


# -- the slow cases, as in tests/test_chaos.py ----------------------------------------


@pytest.mark.slow
def test_full_sweep_zero_violations(tmp_path):
    summary = chaos.sweep(24, str(tmp_path), device="cpu")
    assert summary["scenarios"] == 24
    assert set(summary["aggregators_covered"]) == set(chaos.AGG_POOL)
    assert summary["inertness_pairs"] >= 8
    assert summary["violations"] == [] and summary["quarantined_cells"] == []


@pytest.mark.slow
def test_supervised_sigkill_resume_bit_exact(tmp_path):
    """A chaos child SIGKILLs itself at round 2 (no autosave); relaunched
    under ``BLADES_RESUME=1`` it resumes from its round-1 checkpoint to the
    uninterrupted run's parameters."""
    import numpy as np

    from blades_tpu_torch.supervision import Supervisor

    env = _env()
    ref = tmp_path / "ref.npy"
    p = _chaos(["--child", "--seed", "1", "--device", "cpu", "--out", str(tmp_path / "ref"),
                "--params-out", str(ref)], env)
    assert p.returncode == 0, (p.stdout, p.stderr)
    sup = tmp_path / "sup.npy"
    result = Supervisor(
        [sys.executable, "-m", "blades_tpu_torch.examples.chaos", "--child", "--seed", "1",
         "--device", "cpu", "--out", str(tmp_path / "sup"), "--params-out", str(sup),
         "--kill-at", "2"],
        attempts=2, base_delay_s=0.1, poll_s=0.2,
        telemetry_path=str(tmp_path / "sup" / "telemetry.jsonl"),
        heartbeat_file=str(tmp_path / "hb"), env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL).run()
    assert result.ok
    assert result.attempts[0].reason == "exit" and result.attempts[0].returncode == -9
    assert result.attempts[1].resumed
    np.testing.assert_array_equal(np.load(ref), np.load(sup))
