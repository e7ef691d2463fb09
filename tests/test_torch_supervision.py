"""The run supervisor (``supervision/supervisor.py``), the heartbeat and the
port Simulator's supervised SIGTERM hook, as ``tests/test_supervision.py``
holds the JAX package's, with port children.

The hung children are ``sleep`` stubs and port heartbeat beats; the
end-to-end case is a supervised port ``Simulator`` (the MLP of
``examples/supervised_run.py``, on the CPU) that hangs at round 2: the
heartbeat goes stale, the whole process group is killed (no process left),
the SIGTERM fires the crash autosave (a ``crash_checkpoint`` record naming
``SupervisorTermination``, at round 2), and the relaunch under
``BLADES_RESUME=1`` ends on parameters ``torch.equal`` to an uninterrupted
run's. The degrade policies are the port's: ``no_pallas`` and ``cpu_only``
raise.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from blades_tpu.supervision import POLICIES as JAX_POLICIES
from blades_tpu.utils.retry import backoff_delay as jax_backoff_delay
from blades_tpu_torch.supervision import heartbeat as hb
from blades_tpu_torch.supervision.supervisor import (
    POLICIES,
    DegradePolicy,
    Supervisor,
    kill_process_group,
    list_group,
    resolve_policy,
    supervise,
)
from blades_tpu_torch.telemetry.schema import validate_records
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _sup_events(path):
    return [r for r in _records(path) if r.get("t") == "supervisor"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", hb.HEARTBEAT_ENV, hb.RESUME_ENV, hb.SUPERVISED_ENV)}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(worker_threads()), **extra)
    return env


# -- the heartbeat file ----------------------------------------------------------


def test_beat_noop_without_env(tmp_path, monkeypatch):
    monkeypatch.delenv(hb.HEARTBEAT_ENV, raising=False)
    hb.beat(round_idx=1)
    f = tmp_path / "hb"
    hb.beat(round_idx=3, path=str(f))
    rec = hb.read(str(f))
    assert rec["t"] == "heartbeat" and rec["round"] == 3
    assert hb.age_s(str(f)) < 5.0
    assert hb.age_s(str(tmp_path / "missing")) is None


def test_beat_env_path(tmp_path, monkeypatch):
    f = tmp_path / "hb"
    monkeypatch.setenv(hb.HEARTBEAT_ENV, str(f))
    hb.beat(round_idx=7)
    assert hb.read(str(f))["round"] == 7


def test_beat_never_raises_on_bad_path(monkeypatch):
    monkeypatch.setenv(hb.HEARTBEAT_ENV, "/proc/definitely/not/writable/hb")
    hb.beat(round_idx=1)


# -- process groups ----------------------------------------------------------------


def test_kill_process_group_reaps_grandchildren():
    p = subprocess.Popen(["/bin/sh", "-c", "trap '' TERM; sleep 600 & sleep 600"],
                         start_new_session=True)
    pgid = os.getpgid(p.pid)
    time.sleep(0.3)
    assert len(list_group(pgid)) >= 2
    t0 = time.monotonic()
    info = kill_process_group(p, term_grace_s=0.5)
    assert time.monotonic() - t0 < 15.0
    assert info["escalated"] is True and info["survivors"] == []
    assert list_group(pgid) == []


def test_kill_process_group_graceful_term():
    p = subprocess.Popen(["sleep", "600"], start_new_session=True)
    info = kill_process_group(p, term_grace_s=5.0)
    assert info["escalated"] is False and info["survivors"] == []


def test_sigstopped_child_still_killed():
    p = subprocess.Popen(["sleep", "600"], start_new_session=True)
    os.kill(p.pid, signal.SIGSTOP)
    info = kill_process_group(p, term_grace_s=0.3)
    assert info["survivors"] == [] and p.poll() is not None


# -- the watchdog ------------------------------------------------------------------


def test_hung_child_killed_within_staleness_window(tmp_path):
    telem = tmp_path / "telemetry.jsonl"
    t0 = time.monotonic()
    result = Supervisor(["/bin/sh", "-c", "sleep 600 & sleep 600"], heartbeat_timeout_s=0.5,
                        startup_grace_s=1.0, attempts=1, term_grace_s=0.5, poll_s=0.1,
                        telemetry_path=str(telem), heartbeat_file=str(tmp_path / "hb")).run()
    assert time.monotonic() - t0 < 20.0
    assert not result.ok
    (attempt,) = result.attempts
    assert attempt.reason == "startup_stale" and attempt.survivors == ()
    kills = [e for e in _sup_events(str(telem)) if e["event"] == "kill"]
    assert len(kills) == 1 and kills[0]["survivors"] == [] and kills[0]["kill_s"] >= 0
    assert validate_records(_records(str(telem))) == []


def test_stale_after_beats_triggers_heartbeat_kill(tmp_path):
    code = ("import time; from blades_tpu_torch.supervision.heartbeat import beat; "
            "beat(round_idx=2); time.sleep(600)")
    telem = tmp_path / "telemetry.jsonl"
    result = supervise([sys.executable, "-c", code], heartbeat_timeout_s=1.0,
                       startup_grace_s=60.0, attempts=1, term_grace_s=0.5, poll_s=0.1,
                       telemetry_path=str(telem), heartbeat_file=str(tmp_path / "hb"),
                       env=_env())
    (attempt,) = result.attempts
    assert attempt.reason == "heartbeat_stale"
    (kill,) = [e for e in _sup_events(str(telem)) if e["event"] == "kill"]
    assert kill["last_round"] == 2 and kill["heartbeat_age_s"] > 1.0


def test_beating_child_survives(tmp_path):
    code = ("import time; from blades_tpu_torch.supervision.heartbeat import beat\n"
            "for i in range(5): time.sleep(0.3); beat(round_idx=i)")
    result = supervise([sys.executable, "-c", code], heartbeat_timeout_s=2.0,
                       startup_grace_s=60.0, attempts=1, poll_s=0.1,
                       heartbeat_file=str(tmp_path / "hb"), env=_env())
    assert result.ok and result.attempts[0].reason == "exit"


# -- degrade and resume --------------------------------------------------------------


def test_degrade_ladder_cumulative_and_resume_env(tmp_path):
    """Attempt 1 runs clean, attempt 2 adds the first policy, attempt 3 the
    second on top, and every relaunch exports BLADES_RESUME=1."""
    probe = tmp_path / "attempts.jsonl"
    code = (
        "import json, os, sys\n"
        f"with open({str(probe)!r}, 'a') as f:\n"
        "    f.write(json.dumps({k: os.environ.get(k) for k in\n"
        "        ('CUDA_VISIBLE_DEVICES', 'EXTRA_FLAG', 'BLADES_RESUME',\n"
        "         'BLADES_SUPERVISED', 'BLADES_ATTEMPT')}) + '\\n')\n"
        "sys.exit(1)")
    env = _env()
    env.pop("CUDA_VISIBLE_DEVICES", None)
    result = supervise([sys.executable, "-c", code], attempts=3, base_delay_s=0.01,
                       poll_s=0.05, degrade=["single_device", {"EXTRA_FLAG": 1}],
                       heartbeat_file=str(tmp_path / "hb"), env=env,
                       telemetry_path=str(tmp_path / "telemetry.jsonl"))
    assert not result.ok
    rows = _records(str(probe))
    assert len(rows) == 3
    assert rows[0]["BLADES_SUPERVISED"] == "1" and rows[0]["BLADES_RESUME"] is None
    assert rows[0]["CUDA_VISIBLE_DEVICES"] is None
    assert rows[1]["BLADES_RESUME"] == "1" and rows[1]["CUDA_VISIBLE_DEVICES"] == "0"
    assert rows[1]["EXTRA_FLAG"] is None
    assert rows[2]["EXTRA_FLAG"] == "1" and rows[2]["CUDA_VISIBLE_DEVICES"] == "0"
    assert [r["BLADES_ATTEMPT"] for r in rows] == ["1", "2", "3"]
    events = _sup_events(str(tmp_path / "telemetry.jsonl"))
    assert [e["event"] for e in events].count("degrade") == 2
    assert result.attempts[2].degrade == ("single_device", "custom")


@pytest.mark.parametrize("name", ["no_pallas", "cpu_only"])
def test_the_jax_fallback_policies_raise(name):
    """The JAX package's policies that move off its kernel or its
    accelerator have no port counterpart: naming one raises, at
    resolution and at ``Supervisor`` construction."""
    assert name in JAX_POLICIES
    with pytest.raises(ValueError, match="no fallback off its kernel or its card"):
        resolve_policy(name)
    with pytest.raises(ValueError, match="no fallback"):
        Supervisor(["true"], degrade=[name])


def test_policy_resolution():
    assert set(POLICIES) == {"single_device"}
    assert resolve_policy("single_device") is POLICIES["single_device"]
    assert POLICIES["single_device"].env == {"CUDA_VISIBLE_DEVICES": "0"}
    custom = resolve_policy({"FOO": 1})
    assert custom.name == "custom" and custom.env == {"FOO": "1"}
    own = DegradePolicy("cpu_child", {"FOO": "2"})
    assert resolve_policy(own) is own
    with pytest.raises(ValueError, match="unknown degrade policy"):
        resolve_policy("warp_speed")


def test_backoff_shared_with_retry():
    from blades_tpu_torch.utils.retry import backoff_delay

    assert [backoff_delay(i, 1.0, 60.0) for i in (1, 2, 3, 7)] == [1.0, 2.0, 4.0, 60.0]
    assert [backoff_delay(i, 1.0, 60.0) for i in range(13)] == [
        jax_backoff_delay(i, 1.0, 60.0) for i in range(13)]


# -- the CLI --------------------------------------------------------------------------


def _cli(*argv, timeout=120):
    return subprocess.run([sys.executable, "-m", "blades_tpu_torch.supervision", *argv],
                          capture_output=True, text=True, cwd=ROOT, env=_env(),
                          timeout=timeout)


def test_success_passthrough_single_json_line():
    p = _cli("--attempts", "2", "--deadline", "60", "--", sys.executable, "-c",
             "print('{\"metric\": \"x\", \"value\": 1.0}')")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == '{"metric": "x", "value": 1.0}'
    assert "[supervisor]" in p.stderr


def test_cli_requires_command():
    p = _cli("--attempts", "1")
    assert p.returncode == 2 and "no workload command" in p.stderr


@pytest.mark.parametrize("policy", ["single-device", "no_pallas"])
def test_cli_rejects_unknown_degrade_policy(policy):
    p = _cli("--degrade", policy, "--", "true")
    assert p.returncode == 2
    assert "unknown --degrade policy" in p.stderr and "Traceback" not in p.stderr


def test_unlaunchable_workload_terminates_trail_cleanly(tmp_path):
    telem = tmp_path / "telemetry.jsonl"
    result = supervise(["/definitely/not/a/binary-xyz"], attempts=3,
                       telemetry_path=str(telem), heartbeat_file=str(tmp_path / "hb"))
    assert not result.ok and result.returncode == 127
    (attempt,) = result.attempts
    assert attempt.reason == "launch_failed"
    assert [e["event"] for e in _sup_events(str(telem))][-2:] == ["launch_failed", "give_up"]


def test_cli_never_exits_zero_on_give_up():
    p = _cli("--attempts", "1", "--deadline", "0.5", "--poll", "0.1", "--term-grace", "5",
             "--", "/bin/sh", "-c", "trap 'exit 0' TERM; sleep 600")
    assert p.returncode == 1, (p.returncode, p.stderr)


def test_killed_final_attempt_reports_real_signal(tmp_path):
    result = supervise(["sleep", "600"], deadline_s=0.5, attempts=1, poll_s=0.1,
                       term_grace_s=5.0, heartbeat_file=str(tmp_path / "hb"))
    assert not result.ok and result.returncode == -signal.SIGTERM
    assert result.attempts[0].reason == "deadline"


# -- the Simulator under supervision ------------------------------------------------------


def _mlp_run(log, **kw):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    sim = Simulator(dataset=Synthetic(num_clients=4, train_size=80, test_size=40, cache=False),
                    log_path=log, seed=0, device="cpu")
    sim.run("mlp", global_rounds=1, local_steps=1, train_batch_size=8, validate_interval=1,
            **kw)
    return sim


def test_fresh_unsupervised_run_starts_a_new_trace(tmp_path, monkeypatch):
    monkeypatch.delenv(hb.SUPERVISED_ENV, raising=False)
    log = str(tmp_path / "run")
    _mlp_run(log)
    _mlp_run(log)
    recs = _records(os.path.join(log, "telemetry.jsonl"))
    assert sum(r.get("t") == "round" for r in recs) == 1
    assert sum(r.get("t") == "meta" for r in recs) == 1
    monkeypatch.setenv(hb.SUPERVISED_ENV, "1")
    _mlp_run(log)  # a supervised attempt appends
    recs = _records(os.path.join(log, "telemetry.jsonl"))
    assert sum(r.get("t") == "round" for r in recs) == 2


def test_sigterm_hook_is_installed_only_under_supervision_and_restored(tmp_path, monkeypatch):
    """Under ``BLADES_SUPERVISED=1`` a SIGTERM in the round loop is
    ``SupervisorTermination`` (the crash autosave fires); the previous
    handler is back after the run, and a configuration error that raises
    before the loop never installs it."""
    from blades_tpu_torch.simulator import SupervisorTermination

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setenv(hb.SUPERVISED_ENV, "1")
    seen = []

    def on_round_end(rnd, state, m):
        seen.append(signal.getsignal(signal.SIGTERM))
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(5)  # the handler raises at the next bytecode

    log = str(tmp_path / "run")
    with pytest.raises(SupervisorTermination):
        _mlp_run(log, on_round_end=on_round_end)
    assert seen and seen[0] is not before
    assert signal.getsignal(signal.SIGTERM) is before
    crash = [r for r in _records(os.path.join(log, "telemetry.jsonl"))
             if r.get("t") == "crash_checkpoint"]
    assert len(crash) == 1 and "SupervisorTermination" in crash[0]["error"]
    with pytest.raises(Exception):
        _mlp_run(str(tmp_path / "bad"), compute_dtype="int8")
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.delenv(hb.SUPERVISED_ENV)
    _mlp_run(str(tmp_path / "plain"), on_round_end=lambda *a: seen.append(
        signal.getsignal(signal.SIGTERM)))
    assert seen[-1] is before


def test_supervised_simulator_hang_is_killed_and_resumes_bit_exact(tmp_path):
    """The acceptance case: ``examples/supervised_run.py``'s MLP child,
    supervised, hangs at round 2 after spawning a grandchild; the stale
    heartbeat kills the whole group, the SIGTERM fires the crash autosave,
    and the relaunch resumes to the uninterrupted run's parameters."""
    from blades_tpu_torch.examples import supervised_run

    args = argparse.Namespace(workload="mlp", device="cpu", rounds=3)
    env = _env()
    ref_params = str(tmp_path / "ref.pt")
    p = subprocess.run(supervised_run.child_cmd(args, str(tmp_path / "ref"), ref_params, 0),
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert p.returncode == 0, (p.stdout, p.stderr)

    sup_out = tmp_path / "sup"
    sup_params = str(tmp_path / "sup.pt")
    telem = str(sup_out / "telemetry.jsonl")
    timings = str(tmp_path / "timings.jsonl")
    result = Supervisor(
        supervised_run.child_cmd(args, str(sup_out), sup_params, 2, timings),
        heartbeat_timeout_s=6.0, startup_grace_s=300.0, attempts=2, base_delay_s=0.1,
        term_grace_s=10.0, poll_s=0.2, telemetry_path=telem,
        heartbeat_file=str(tmp_path / "hb"), env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    ).run()
    assert result.ok, result
    first, second = result.attempts
    assert first.reason == "heartbeat_stale" and first.survivors == ()
    assert second.reason == "exit" and second.resumed
    assert torch.equal(torch.load(ref_params), torch.load(sup_params))

    records = _records(telem)
    events = [e for e in records if e.get("t") == "supervisor"]
    kinds = [e["event"] for e in events]
    for expected in ("launch", "kill", "retry", "launch", "complete"):
        assert expected in kinds, kinds
    (kill,) = [e for e in events if e["event"] == "kill"]
    assert kill["reason"] == "heartbeat_stale" and kill["survivors"] == []
    # the hang is in round 2's on_round_end, before round 2's beat
    assert kill["last_round"] == 1
    launches = [e for e in events if e["event"] == "launch"]
    assert launches[0]["resume"] is False and launches[1]["resume"] is True
    # round 2's state rode the crash autosave, its round record was lost
    assert {r["round"] for r in records if r.get("t") == "round"} == {1, 3}
    crash = [r for r in records if r.get("t") == "crash_checkpoint"]
    assert crash and crash[0]["round"] == 2
    assert "SupervisorTermination" in crash[0]["error"]
    assert [r["path"] for r in records if r.get("t") == "span" and r["path"] == "restore"] == [
        "restore"]
    assert validate_records(records) == []
    notes = _records(timings)
    assert [n["round"] for n in notes if n["event"] == "round"] == [1, 2, 3]
    assert [n["attempt"] for n in notes if n["event"] == "start"] == [1, 2]
    assert [n["event"] for n in notes].count("hang") == 1
