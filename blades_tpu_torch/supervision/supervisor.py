"""The run supervisor: a heartbeat watchdog, process groups killed whole, and
relaunch with resume.

Counterpart: ``blades_tpu/supervision/supervisor.py`` — ``DegradePolicy``
(:70), ``POLICIES`` (:90-123), ``resolve_policy`` (:128), ``list_group``
(:145), ``kill_process_group`` (:174), ``Supervisor`` (:258, ``_watch``
:392, ``run`` :418), ``supervise`` (:546) and ``main`` (:551). A hung run (a
stuck collective, a card that stopped answering) raises nothing, so no
``try`` inside it can help; the supervisor turns a hang into a bounded,
recorded recovery:

1. The workload starts in a session of its own (``start_new_session``):
   it and every process it spawns share a process group, killed at once.
2. The workload beats a heartbeat file once a round
   (``supervision/heartbeat.py``, at ``Simulator.run``'s flush, and at each
   sweep cell). A beat older than ``heartbeat_timeout_s``, no first beat
   within ``startup_grace_s``, or a wall clock past ``deadline_s`` kills
   the attempt.
3. The kill is SIGTERM (a supervised ``Simulator.run`` turns it into
   ``SupervisorTermination``, and its crash autosave fires), SIGCONT (a
   stopped child still takes the TERM), then SIGKILL after
   ``term_grace_s``, all through ``os.killpg``; a ``/proc`` scan then
   checks that no process of the group is left.
4. The relaunch runs under ``BLADES_RESUME=1`` (``Simulator.run`` goes on
   from its crash autosave or checkpoint, bit for bit; a sweep from its
   journal) after :func:`~blades_tpu_torch.utils.retry.backoff_delay`, and
   may apply a :class:`DegradePolicy`.

Every launch, kill, degrade, retry and the end go to the trace as
``supervisor`` records, beside the run's own records, and a kill to the run
ledger (``telemetry/ledger.py``). The port's records add ``ts`` to each,
and to a kill the heartbeat's age when it was decided and the seconds the
group took to die (``kill_s``, the crash autosave included): the parts of
the time to recover.

**The port's policies.** The JAX package's ``no_pallas`` moves off the
Pallas kernel (``BLADES_TPU_NO_PALLAS=1``) and ``cpu_only`` off the TPU.
The port has no way off its kernel or its card, and its entry points raise
where the card is missing; a policy that hid a fallback would turn a
recovery into a different run. So :data:`POLICIES` holds ``single_device``
(``CUDA_VISIBLE_DEVICES=0``) only, and :func:`resolve_policy` refuses
``no_pallas`` and ``cpu_only``. A caller may still pass an environment dict
of its own, with a workload command that asks for ``--device cpu`` itself.

The module itself uses the standard library only (the port's ledger,
which it records kills in, loads torch).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from blades_tpu_torch.supervision import heartbeat as hb
from blades_tpu_torch.telemetry import Recorder
from blades_tpu_torch.telemetry import alerts as _alerts
from blades_tpu_torch.telemetry import context as _context
from blades_tpu_torch.telemetry import ledger as _ledger
from blades_tpu_torch.utils.retry import backoff_delay

# -- degradation policies -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """A named set of environment overrides a relaunch applies. Policies
    add up: attempt ``n`` runs under the first ``n - 1`` configured
    policies (a later one wins a key), so a run degrades one way only."""

    name: str
    env: Dict[str, str]
    note: str = ""


#: The port's built-in policies: ``single_device`` keeps the relaunch on
#: the first card
POLICIES: Dict[str, DegradePolicy] = {
    p.name: p
    for p in (
        DegradePolicy("single_device", {"CUDA_VISIBLE_DEVICES": "0"},
                      "run the relaunch on the first card only"),
    )
}

#: the JAX package's policies that the port refuses, and why
_REFUSED = {
    "no_pallas": "moves the JAX package off its Pallas kernel",
    "cpu_only": "moves the JAX package off its accelerator",
}


def resolve_policy(p: Union[str, DegradePolicy, Dict[str, str]]) -> DegradePolicy:
    """A policy from its registry name, a policy, or a raw environment dict."""
    if isinstance(p, DegradePolicy):
        return p
    if isinstance(p, str):
        if p in _REFUSED:
            raise ValueError(
                f"degrade policy {p!r} {_REFUSED[p]}; blades_tpu_torch has no fallback off "
                "its kernel or its card (its entry points raise where the card is missing). "
                "Pass an environment dict with a workload command that asks for "
                "'--device cpu' itself")
        try:
            return POLICIES[p]
        except KeyError:
            raise ValueError(f"unknown degrade policy {p!r} (built-ins: {sorted(POLICIES)})"
                             ) from None
    return DegradePolicy("custom", {k: str(v) for k, v in dict(p).items()})


# -- process groups -----------------------------------------------------------


def list_group(pgid: int) -> List[int]:
    """The live pids of process group ``pgid`` (a ``/proc`` scan; Linux),
    zombies left out: they hold nothing."""
    pids = []
    try:
        entries = os.listdir("/proc")
    except OSError:
        return pids
    for entry in entries:
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat", "rb") as fh:
                stat = fh.read().decode("ascii", "replace")
            # field 2, "(comm)", may hold spaces and parentheses: parse
            # from the last ')'; the state is field 3, the group field 5
            rest = stat[stat.rfind(")") + 2:].split()
            state, pgrp = rest[0], int(rest[2])
        except (OSError, ValueError, IndexError):
            continue
        if pgrp == pgid and state != "Z":
            pids.append(int(entry))
    return pids


def kill_process_group(proc: subprocess.Popen, term_grace_s: float = 10.0,
                       kill_wait_s: float = 10.0) -> Dict[str, object]:
    """SIGTERM, SIGCONT, then after ``term_grace_s`` SIGKILL, to the whole
    group of ``proc``. Returns ``{"pgid", "escalated" (SIGKILL was
    needed), "survivors" (pids alive after it; [] on success)}``. Never
    signals the supervisor's own group."""
    try:
        pgid = os.getpgid(proc.pid)
    except OSError:
        pgid = proc.pid
    info: Dict[str, object] = {"pgid": pgid, "escalated": False, "survivors": []}
    if pgid == os.getpgid(0):
        proc.kill()
        proc.wait()
        return info

    def _signal_group(sig: int) -> None:
        try:
            os.killpg(pgid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    _signal_group(signal.SIGTERM)
    _signal_group(signal.SIGCONT)
    deadline = time.monotonic() + term_grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None and not list_group(pgid):
            return info
        time.sleep(0.05)
    info["escalated"] = True
    _signal_group(signal.SIGKILL)
    try:
        proc.wait(timeout=kill_wait_s)
    except subprocess.TimeoutExpired:
        pass
    # grandchildren are reparented and reaped later: a bounded wait
    deadline = time.monotonic() + kill_wait_s
    survivors = list_group(pgid)
    while survivors and time.monotonic() < deadline:
        time.sleep(0.05)
        survivors = list_group(pgid)
    info["survivors"] = survivors
    return info


# -- the supervisor -----------------------------------------------------------


@dataclasses.dataclass
class AttemptRecord:
    """One launch's outcome (``Supervisor.run`` returns the list)."""

    index: int
    returncode: Optional[int]  # None when the watchdog killed the attempt
    # "exit" | "deadline" | "heartbeat_stale" | "startup_stale" | "alert"
    # | "launch_failed"
    reason: str
    wall_s: float
    degrade: Tuple[str, ...] = ()
    resumed: bool = False
    survivors: Tuple[int, ...] = ()


@dataclasses.dataclass
class SupervisedResult:
    ok: bool
    returncode: Optional[int]
    attempts: List[AttemptRecord]


class Supervisor:
    """Launch ``cmd`` in a process group of its own and keep it making
    progress.

    ``deadline_s``: a wall-clock limit an attempt. ``heartbeat_timeout_s``:
    the largest age of the heartbeat once the workload has beaten.
    ``startup_grace_s``: the time allowed before the first beat (CUDA's
    start and a cold ``nvcc`` build of the kernel fall in it).
    ``attempts``: the launches in all. ``base_delay_s`` / ``max_delay_s``:
    the backoff between attempts. ``degrade``: policy specs, relaunch
    ``n`` applying the first ``n - 1``. ``resume``: export
    ``BLADES_RESUME=1`` on relaunches. ``kill_on_alert``: export
    ``BLADES_ALERT_FILE``, so a critical alert (``telemetry/alerts.py``)
    kills the attempt at once. ``telemetry_path``: the JSONL file of the
    ``supervisor`` records (None: none). ``heartbeat_file``: default
    ``<telemetry dir>/heartbeat``. ``stdout`` / ``stderr``: ``None``
    inherits the supervisor's streams."""

    def __init__(
        self,
        cmd: Sequence[str],
        *,
        deadline_s: Optional[float] = None,
        heartbeat_timeout_s: Optional[float] = None,
        startup_grace_s: float = 900.0,
        attempts: int = 3,
        base_delay_s: float = 1.0,
        max_delay_s: float = 60.0,
        degrade: Sequence[Union[str, DegradePolicy, Dict[str, str]]] = (),
        resume: bool = True,
        kill_on_alert: bool = False,
        telemetry_path: Optional[str] = None,
        heartbeat_file: Optional[str] = None,
        env: Optional[Dict[str, str]] = None,
        cwd: Optional[str] = None,
        poll_s: float = 0.2,
        term_grace_s: float = 10.0,
        stdout=None,
        stderr=None,
        sleep=time.sleep,
    ):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        self.cmd = [str(c) for c in cmd]
        self.deadline_s = deadline_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.startup_grace_s = startup_grace_s
        self.attempts = attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.degrade = [resolve_policy(p) for p in degrade]
        self.resume = resume
        self.poll_s = poll_s
        self.term_grace_s = term_grace_s
        self.env = dict(env or {})
        self.cwd = cwd
        self.stdout = stdout
        self.stderr = stderr
        self._sleep = sleep
        if heartbeat_file is None:
            base = (os.path.dirname(telemetry_path) if telemetry_path
                    else f"/tmp/blades_supervisor_{os.getpid()}")
            heartbeat_file = os.path.join(base or ".", "heartbeat")
        self.heartbeat_file = heartbeat_file
        self.kill_on_alert = kill_on_alert
        # the file a critical alert touches, beside the heartbeat
        self.alert_file = os.path.join(os.path.dirname(self.heartbeat_file) or ".", "alert")
        # one run id for every attempt (each attempt re-exports it with its
        # number); fresh: an id an earlier run of this process minted is not
        # this run's
        self.ctx = _context.activate(fresh=True)
        self._rec = Recorder(path=telemetry_path, enabled=telemetry_path is not None,
                             meta={"run": "supervisor", "cmd": self.cmd})

    def _event(self, event: str, **fields) -> None:
        self._rec.event("supervisor", event=event, ts=time.time(), **fields)
        self._rec.flush()

    def _attempt_env(self, attempt: int) -> Tuple[Dict[str, str], List[str]]:
        env = dict(os.environ)
        env.update(self.env)
        env[hb.SUPERVISED_ENV] = "1"
        env[hb.HEARTBEAT_ENV] = self.heartbeat_file
        env[_context.RUN_ID_ENV] = self.ctx.run_id
        env[_context.ATTEMPT_ENV] = str(attempt)
        if self.kill_on_alert:
            env[_alerts.ALERT_FILE_ENV] = self.alert_file
        if self.heartbeat_timeout_s is not None:
            # the workload gauges its margin to the kill threshold
            env[hb.TIMEOUT_ENV] = str(self.heartbeat_timeout_s)
        applied: List[str] = []
        for policy in self.degrade[: attempt - 1]:
            env.update(policy.env)
            applied.append(policy.name)
        if attempt > 1 and self.resume:
            env[hb.RESUME_ENV] = "1"
        return env, applied

    def _watch(self, proc: subprocess.Popen) -> Tuple[str, Optional[int]]:
        """Poll until the exit or a watchdog trip: ``(reason, returncode)``."""
        t0 = time.monotonic()
        while True:
            rc = proc.poll()
            if rc is not None:
                return "exit", rc
            now = time.monotonic()
            if self.deadline_s is not None and now - t0 > self.deadline_s:
                return "deadline", None
            if self.kill_on_alert and os.path.exists(self.alert_file):
                return "alert", None
            if self.heartbeat_timeout_s is not None:
                age = hb.age_s(self.heartbeat_file)
                if age is None:
                    if now - t0 > self.startup_grace_s:
                        return "startup_stale", None
                elif age > self.heartbeat_timeout_s:
                    return "heartbeat_stale", None
            self._sleep(self.poll_s)

    def run(self) -> SupervisedResult:
        records: List[AttemptRecord] = []
        last_proc_rc: Optional[int] = None
        for attempt in range(1, self.attempts + 1):
            env, applied = self._attempt_env(attempt)
            resumed = attempt > 1 and self.resume
            # the last attempt's beat is not this one's liveness, nor may its
            # critical alert kill the relaunch
            for stale in (self.heartbeat_file, self.alert_file):
                try:
                    os.unlink(stale)
                except OSError:
                    pass
            if applied:
                self._event("degrade", attempt=attempt, policies=applied,
                            env={k: v for p in self.degrade[: attempt - 1]
                                 for k, v in p.env.items()})
            self._event("launch", attempt=attempt, cmd=self.cmd, degrade=applied,
                        resume=resumed, heartbeat_file=self.heartbeat_file)
            t0 = time.monotonic()
            try:
                proc = subprocess.Popen(self.cmd, env=env, cwd=self.cwd,
                                        start_new_session=True, stdout=self.stdout,
                                        stderr=self.stderr)
            except OSError as e:
                # an argv that cannot start is no transient failure
                self._event("launch_failed", attempt=attempt,
                            error=f"{type(e).__name__}: {e}"[:300])
                records.append(AttemptRecord(index=attempt, returncode=None,
                                             reason="launch_failed",
                                             wall_s=time.monotonic() - t0,
                                             degrade=tuple(applied), resumed=resumed))
                self._event("give_up", attempts=attempt)
                self._rec.close()
                return SupervisedResult(False, 127, records)
            reason, rc = self._watch(proc)
            if reason != "exit":
                # a child that finished in the poll gap is an exit, not a kill:
                # a finished run already removed its autosave
                rc = proc.poll()
                if rc is not None:
                    reason = "exit"
            survivors: Tuple[int, ...] = ()
            if reason != "exit":
                last = hb.read(self.heartbeat_file) or {}
                alert = None
                if reason == "alert":
                    try:
                        with open(self.alert_file) as fh:
                            alert = json.loads(fh.read())
                    except (OSError, ValueError):
                        pass
                heartbeat_age = hb.age_s(self.heartbeat_file)
                t_kill = time.monotonic()
                info = kill_process_group(proc, term_grace_s=self.term_grace_s)
                survivors = tuple(info["survivors"])  # type: ignore[arg-type]
                self._event("kill", attempt=attempt, reason=reason, pgid=info["pgid"],
                            escalated=info["escalated"], survivors=list(survivors),
                            heartbeat_age_s=heartbeat_age, last_round=last.get("round"),
                            kill_s=round(time.monotonic() - t_kill, 3),
                            **({"alert": alert} if alert else {}))
                # the killed child wrote no ledger end: record it under the
                # shared run id and this attempt
                _ledger.record_event(
                    "supervised", "killed", run_id=self.ctx.run_id, attempt=attempt,
                    reason=reason,
                    **({"metrics": {"last_round": last["round"]}}
                       if isinstance(last.get("round"), int) else {}))
                rc = proc.returncode
            last_proc_rc = rc
            wall = time.monotonic() - t0
            records.append(AttemptRecord(
                index=attempt, returncode=rc if reason == "exit" else None, reason=reason,
                wall_s=wall, degrade=tuple(applied), resumed=resumed, survivors=survivors))
            self._event("exit", attempt=attempt, reason=reason, returncode=rc,
                        wall_s=round(wall, 3))
            if reason == "exit" and rc == 0:
                self._event("complete", attempts=attempt)
                self._rec.close()
                return SupervisedResult(True, 0, records)
            if attempt < self.attempts:
                delay = backoff_delay(attempt, self.base_delay_s, self.max_delay_s)
                self._event("retry", attempt=attempt, delay_s=delay, resume=self.resume)
                self._sleep(delay)
        self._event("give_up", attempts=self.attempts)
        self._rec.close()
        # the last attempt's own returncode (-15 when the child took the
        # SIGTERM, -9 when SIGKILL was needed)
        return SupervisedResult(False, last_proc_rc, records)


def supervise(cmd: Sequence[str], **kwargs) -> SupervisedResult:
    """One call: ``supervise([sys.executable, "-m", "..."], deadline_s=3600)``."""
    return Supervisor(cmd, **kwargs).run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m blades_tpu_torch.supervision [opts] -- cmd args...``.

    The workload's streams are inherited; the supervisor's lines go to
    standard error. The exit code is the workload's last one, or ``128 +
    signal`` when the watchdog killed the last attempt."""
    import argparse

    parser = argparse.ArgumentParser(prog="blades_tpu_torch.supervision",
                                     description="heartbeat-watchdog run supervisor")
    parser.add_argument("--deadline", type=float, default=None,
                        help="wall-clock limit an attempt (s)")
    parser.add_argument("--heartbeat-timeout", type=float, default=None,
                        help="the largest age of the round heartbeat (s)")
    parser.add_argument("--startup-grace", type=float, default=900.0,
                        help="time allowed before the first beat (s)")
    parser.add_argument("--attempts", type=int, default=3)
    parser.add_argument("--base-delay", type=float, default=1.0)
    parser.add_argument("--max-delay", type=float, default=60.0)
    parser.add_argument("--term-grace", type=float, default=10.0)
    parser.add_argument("--poll", type=float, default=0.2)
    parser.add_argument("--degrade", action="append", default=[], metavar="POLICY",
                        help=f"a degradation step (built-ins: {sorted(POLICIES)}); "
                             "repeatable, applied cumulatively from the first relaunch on")
    parser.add_argument("--no-resume", action="store_true",
                        help="do not export BLADES_RESUME=1 on relaunches")
    parser.add_argument("--kill-on-alert", action="store_true",
                        help="kill the attempt at the workload's first critical alert "
                             "(telemetry/alerts.py)")
    parser.add_argument("--heartbeat-file", default=None)
    parser.add_argument("--telemetry", default=None,
                        help="JSONL file of the supervisor records (e.g. the run's "
                             "telemetry.jsonl)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER, help="-- workload argv")
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no workload command given (use: ... -- python -m ...)")
    for name in args.degrade:
        try:
            resolve_policy(name)
        except ValueError as e:
            parser.error(f"unknown --degrade policy {name!r}: {e}")
    if args.deadline is None and args.heartbeat_timeout is None:
        print("[supervisor] warning: neither --deadline nor --heartbeat-timeout is set; "
              "hangs will NOT be detected (exit-code supervision and retries only)",
              file=sys.stderr)

    result = supervise(
        cmd, deadline_s=args.deadline, heartbeat_timeout_s=args.heartbeat_timeout,
        startup_grace_s=args.startup_grace, attempts=args.attempts,
        base_delay_s=args.base_delay, max_delay_s=args.max_delay,
        term_grace_s=args.term_grace, poll_s=args.poll, degrade=args.degrade,
        resume=not args.no_resume, kill_on_alert=args.kill_on_alert,
        heartbeat_file=args.heartbeat_file, telemetry_path=args.telemetry)
    for a in result.attempts:
        print(f"[supervisor] attempt {a.index}: {a.reason} rc={a.returncode} "
              f"wall={a.wall_s:.1f}s"
              + (f" degrade={list(a.degrade)}" if a.degrade else "")
              + (" resumed" if a.resumed else ""), file=sys.stderr)
    if result.ok:
        return 0
    rc = result.returncode
    if rc is None:
        return 128 + signal.SIGKILL
    if rc == 0:
        # the watchdog gave up though the child trapped SIGTERM and exited
        # 0: never report success for a run the trail records as give_up
        return 1
    return rc if rc > 0 else 128 - rc
