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
    """The worker pool (slice 13b.2) was the last part of the service
    that raised; now ``SimulationService(workers=2)`` builds and
    ``examples/serve.py start --workers 2 --device cpu`` serves a probe
    request in a worker and drains to exit 0 with its ``workers`` block."""
    from blades_tpu_torch.service.client import ServiceClient
    from blades_tpu_torch.service.server import SimulationService

    assert SimulationService(str(tmp_path / "svc"), workers=2).workers == 2
    out = tmp_path / "svc2"
    proc = subprocess.Popen([sys.executable, "-m", "blades_tpu_torch.examples.serve", "start",
                             "--out", str(out), "--workers", "2", "--device", "cpu"],
                            cwd=ROOT, env=_env(BLADES_LEDGER=str(tmp_path / "l.jsonl")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = ServiceClient(str(out / "service.sock"), connect_retries=100,
                               connect_delay_s=0.1)
        reply = client.submit({"kind": "probe", "cells": [{"label": "a", "op": "ok"}]})
        client.drain()
        stdout, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    (line,) = [ln for ln in stdout.splitlines() if ln.strip()]
    summary = json.loads(line)
    assert proc.returncode == 0 and reply["ok"] and summary["ok"] is True
    assert summary["workers"]["size"] == 2 and summary["served"] == 1


def test_service_flag_runs_the_drills(tmp_path_factory, capsys):
    # a short base directory: each drill's socket path must stay within
    # the 108 bytes a unix socket's path may take
    rc = chaos.main(["--service", "reduced", "--out", str(tmp_path_factory.mktemp("d"))])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["ok"] is True and summary["metric"] == "chaos_service"
    assert [r["name"] for r in summary["scenarios"]] == [
        "poison_isolated", "backpressure", "deadline_hang", "drain_no_loss", "tenant_flood",
        "preempt_resume", "worker_crash", "worker_hang"]


def test_worker_drills_pass_as_in_the_jax_suite(tmp_path_factory, monkeypatch):
    """``worker_crash`` and ``worker_hang`` against the port's pool (probe
    workers on the CPU) pass, and their rows are the JAX suite's against
    its own pool but for the wall."""
    monkeypatch.setenv("OMP_NUM_THREADS", str(worker_threads()))
    monkeypatch.delenv("BLADES_RESUME", raising=False)
    rows = {}
    for name, mod in (("port", chaos), ("jax", jax_chaos)):
        # short base directories: a unix socket's path takes at most 108 bytes
        out = str(tmp_path_factory.mktemp(name[0]))
        rows[name] = [mod._scn_worker_crash(out), mod._scn_worker_hang(out)]
    assert all(r["ok"] for r in rows["port"]), rows["port"]
    strip = lambda rs: [{k: v for k, v in r.items() if k != "wall_s"} for r in rs]  # noqa: E731
    assert strip(rows["port"]) == strip(rows["jax"])
    crash = rows["port"][0]
    assert crash["content_identical"] and crash["resumed_skipped"] == 1
    assert crash["executed"] == 2 and crash["restarts"] == 1


def test_via_service_runs_the_sweep_on_a_live_server(tmp_path, capsys):
    """``--via-service`` against a port server on the CPU: the summary's
    rows equal the same sweep run in this process."""
    out = tmp_path / "svc"
    server = subprocess.Popen([sys.executable, "-m", "blades_tpu_torch.examples.serve", "start",
                               "--out", str(out), "--device", "cpu"], cwd=ROOT,
                              env=_env(BLADES_LEDGER=str(tmp_path / "l.jsonl")),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        from blades_tpu_torch.service.client import ServiceClient

        ServiceClient(str(out / "service.sock"), connect_retries=100,
                      connect_delay_s=0.1).ping()
        rc = chaos.main(["--sweep", "1", "--via-service", str(out / "service.sock")])
        served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        ServiceClient(str(out / "service.sock")).drain()
        server.communicate(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate()
    assert rc == 0 and served["ok"] is True and server.returncode == 0
    local = chaos.sweep(1, str(tmp_path / "local"), device="cpu")
    assert served["results"] == local["results"] and served["violations"] == []


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
