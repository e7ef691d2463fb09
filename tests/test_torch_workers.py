"""The service's worker pool of the port (``blades_tpu_torch/service/
worker.py``, ``workers.py`` and ``server.py:_work_pool``) on the CPU, the
port's form of ``tests/test_workers.py``, against real ``examples/serve.py
start --workers N --device cpu`` subprocesses:

- spawn, ready and shutdown leave zero survivors in any process group the
  pool spawned;
- a busy worker SIGKILLed mid-request: the server stays up, the
  replacement runs only the unjournaled cells, the reply equals an
  undisturbed run's;
- a worker hung past its cell's deadline is killed by its parent (no
  SIGALRM anywhere) and the retry completes;
- a repeat request goes to the worker that served its body;
- ``--workers 0`` gives the pool's reply and no ``workers`` block;
- ``deadline="external"`` writes no ``deadline_unenforced`` record, and
  the two packages' executors call ``on_cell_start`` alike.

And the port's own: a served simulate cell through a worker against the
JAX service's reply (``rtol=1e-4, atol=1e-5``, the port handed the JAX
run's draws) and bit for bit the in-process server's; certify and probe
requests through ``serve start --workers 2``; a worker whose device dies
(``DeviceLost``) exits without a reply and its request completes on a
fresh worker.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from blades_tpu.sweeps.resilient import ResilienceOptions as JaxOptions
from blades_tpu.sweeps.resilient import run_cells_resilient as jax_run_cells
from blades_tpu_torch.service import worker as worker_mod
from blades_tpu_torch.service.client import ServiceClient, ServiceError
from blades_tpu_torch.service.protocol import socket_path_for
from blades_tpu_torch.service.server import SimulationService
from blades_tpu_torch.service.workers import WorkerPool
from blades_tpu_torch.sweeps.resilient import ResilienceOptions, run_cells_resilient
from blades_tpu_torch.telemetry.schema import validate_records
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

SIM_REQUEST = {"kind": "simulate", "cells": [
    {"label": "m", "agg": "trimmedmean", "agg_kws": {"num_byzantine": 2}, "attack": "alie",
     "num_byz": 2, "rounds": 2, "seed": 1}]}


def _env(tmp_path, name, extra_path=None, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "BLADES_RESUME", "BLADES_SWEEP_KILL_AT")}
    env.update(PYTHONPATH=os.pathsep.join(([extra_path] if extra_path else []) + [ROOT]),
               OMP_NUM_THREADS=str(worker_threads()), JAX_PLATFORMS="cpu",
               BLADES_LEDGER=str(tmp_path / f"{name}_ledger.jsonl"), **extra)
    return env


def _start(tmp_path, name, *extra, extra_path=None):
    out = str(tmp_path / name)
    proc = subprocess.Popen(
        [sys.executable, "-m", "blades_tpu_torch.examples.serve", "start", "--out", out,
         "--base-delay", "0.05", "--device", "cpu", *extra],
        cwd=ROOT, env=_env(tmp_path, name, extra_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    client = ServiceClient(socket_path_for(out), timeout=120, connect_retries=100,
                           connect_delay_s=0.1)
    return out, proc, client


def _finish(proc, client):
    try:
        if proc.poll() is None:
            client.drain()
    except ServiceError:
        pass
    out, err = proc.communicate(timeout=120)
    return proc.returncode, out, err


def _trace(out_dir):
    with open(os.path.join(out_dir, "service_trace.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _finished(out_dir):
    return [r for r in _trace(out_dir) if r.get("t") == "request" and r.get("event") == "finished"]


# -- the pool's life -----------------------------------------------------------------


def test_pool_spawn_ready_shutdown_zero_orphans(tmp_path):
    """Each worker is a process group of its own, never the server's; a
    clean shutdown kills nothing, and no process of any group the pool
    spawned survives it."""
    pool = WorkerPool(2, str(tmp_path), device="cpu")
    pool.start()
    try:
        ready = set()
        deadline = time.monotonic() + 60
        while len(ready) < 2 and time.monotonic() < deadline:
            for wid, ev in pool.poll(1.0):
                if ev.get("ev") == "ready":
                    ready.add(wid)
                    pool.workers[wid].state = "idle"
        assert ready == {"w0", "w1"}
        own = os.getpgid(0)
        assert all(h.pgid != own for h in pool.workers.values())
        snap = pool.snapshot()
        assert snap["size"] == 2 and snap["idle"] == 2 and snap["busy"] == 0
        assert all("--device" in h.proc.args and "cpu" in h.proc.args
                   for h in pool.workers.values())
    finally:
        res = pool.shutdown()
    assert res["survivors"] == [] and res["kills"] == 0
    assert pool.orphans() == []
    assert all(h.proc.poll() is not None for h in pool.workers.values())


# -- a worker's crash and a hang ------------------------------------------------------


def test_sigkill_busy_worker_resume_content_identical(tmp_path):
    request = {"kind": "probe", "cells": [
        {"label": "c0", "op": "ok", "value": 0},
        {"label": "s", "op": "sleep", "sleep_s": 3.0, "value": 1},
        {"label": "c2", "op": "ok", "value": 2},
    ]}
    out, proc, client = _start(tmp_path, "sigkill", "--workers", "1")
    try:
        ref = client.submit(request, request_id="ref", timeout=120)
        assert ref.get("ok") and ref.get("status") == "done"
        victim = client.submit(request, request_id="victim", wait=False)
        pid = None
        deadline = time.monotonic() + 30
        while pid is None and time.monotonic() < deadline:
            by = (client.status().get("workers") or {}).get("by_worker") or {}
            for w in by.values():
                if w.get("state") == "busy" and w.get("cell") == "s":
                    pid = w["pid"]
            if pid is None:
                time.sleep(0.05)
        assert pid is not None, "the worker never reached the sleep cell"
        os.kill(pid, signal.SIGKILL)
        reply = client.wait_result(victim["id"], timeout=120)["reply"]
        workers = client.status().get("workers") or {}
    finally:
        rc, _, err = _finish(proc, client)
    assert rc == 0, err[-2000:]
    assert reply.get("ok") and reply["cells"] == ref["cells"]
    summary = reply.get("summary") or {}
    assert summary.get("resumed_skipped", 0) >= 1
    assert summary.get("executed", 9) <= len(request["cells"]) - 1
    assert workers.get("restarts", 0) >= 1
    events = [r.get("event") for r in _trace(out) if r.get("t") == "worker"]
    assert "crash" in events and "replace" in events
    assert validate_records(_trace(out)) == []


def test_parent_enforced_deadline_reaps_hung_worker(tmp_path):
    sentinel = str(tmp_path / "hang.once")
    out, proc, client = _start(tmp_path, "deadline", "--workers", "1", "--cell-deadline", "0.5",
                               "--attempts", "2")
    try:
        t0 = time.monotonic()
        reply = client.submit({"kind": "probe", "cells": [
            {"label": "hang", "op": "sleep", "sleep_s": 600, "once": sentinel, "value": 3},
            {"label": "after", "op": "ok", "value": 4},
        ]}, request_id="hang", timeout=120)
        wall = time.monotonic() - t0
        alive = client.submit({"kind": "probe", "cells": [{"label": "ok", "op": "ok"}]},
                              timeout=60)
        workers = client.status().get("workers") or {}
    finally:
        rc, _, err = _finish(proc, client)
    assert rc == 0, err[-2000:]
    assert reply.get("ok") and reply.get("status") == "done"
    cells = {c["label"]: c for c in reply["cells"]}
    assert cells["hang"]["result"]["value"] == 3 and not cells["hang"].get("quarantined")
    assert cells["after"]["result"]["value"] == 4
    assert wall < 60.0 and alive.get("ok")
    assert workers.get("kills", 0) >= 1 and workers.get("restarts", 0) >= 1
    kills = [r for r in _trace(out) if r.get("t") == "worker" and r.get("event") == "kill"]
    assert kills and kills[0]["cell"] == "hang" and kills[0]["reason"] == "deadline"


# -- routing and the in-process path --------------------------------------------------


def test_warm_affinity_repeat_lands_on_warm_worker(tmp_path):
    body = {"kind": "probe", "cells": [{"label": "a", "op": "ok", "value": 1}]}
    out, proc, client = _start(tmp_path, "warm", "--workers", "2")
    try:
        r1 = client.submit(dict(body), request_id="r1", timeout=60)
        r2 = client.submit(dict(body), request_id="r2", timeout=60)
        by = (client.status().get("workers") or {}).get("by_worker") or {}
    finally:
        rc, _, err = _finish(proc, client)
    assert rc == 0, err[-2000:]
    assert r1.get("ok") and r2.get("ok")
    assert sorted(w.get("served", 0) for w in by.values()) == [0, 2]
    fin = _finished(out)
    assert len(fin) == 2 and fin[0]["worker"] == fin[1]["worker"]
    # a probe builds nothing: the repeat is warm by the worker's own counters
    assert fin[1].get("warm") is True and fin[1].get("compiles", 1) == 0
    # the admission wakes the dispatch loop: no request waits out its poll
    assert all(r["queue_wait_s"] < 0.4 for r in fin)


def test_workers_zero_matches_inprocess_path(tmp_path):
    request = {"kind": "probe", "cells": [
        {"label": f"c{i}", "op": "ok", "value": i} for i in range(3)]}
    _, proc0, client0 = _start(tmp_path, "inproc")
    try:
        r0 = client0.submit(request, request_id="same", timeout=60)
        st0 = client0.status()
    finally:
        rc0, _, err0 = _finish(proc0, client0)
    _, proc1, client1 = _start(tmp_path, "pooled", "--workers", "1")
    try:
        r1 = client1.submit(request, request_id="same", timeout=60)
        st1 = client1.status()
    finally:
        rc1, _, err1 = _finish(proc1, client1)
    assert rc0 == 0, err0[-2000:]
    assert rc1 == 0, err1[-2000:]
    assert "workers" not in st0 and st1["workers"]["size"] == 1
    for key in ("ok", "status", "id", "cells", "summary"):
        assert r0.get(key) == r1.get(key), key


# -- the executor's hooks -------------------------------------------------------------


def test_deadline_unenforced_note_surfaces(tmp_path):
    """From a non-main thread an alarm deadline writes one
    ``deadline_unenforced`` record, which the JAX package's
    ``sweep_status.py`` counts; ``deadline="external"`` writes none."""
    import sweep_status

    from blades_tpu_torch.telemetry.timeline import SweepAccounting

    def run_in_thread(trace, **opt_kw):
        sw = SweepAccounting("certify", total=2, path=trace)
        box = {}

        def run():
            box["out"] = run_cells_resilient(
                [("c0", {}), ("c1", {})], lambda payload: {"ok": True}, sweep=sw,
                options=ResilienceOptions(attempts=1, cell_deadline_s=0.5,
                                          sleep=lambda s: None, **opt_kw))

        t = threading.Thread(target=run)
        t.start()
        t.join(60)
        sw.close()
        with open(trace) as fh:
            return box["out"], [json.loads(line) for line in fh]

    (results, _, _), records = run_in_thread(str(tmp_path / "a.jsonl"))
    assert results == [{"ok": True}, {"ok": True}]
    notes = [r for r in records if r.get("t") == "deadline_unenforced"]
    assert len(notes) == 1 and notes[0]["reason"] == "non_main_thread"
    assert notes[0]["deadline_s"] == 0.5
    assert sweep_status.summarize_sweeps(records)["sweeps"]["certify"]["deadline_unenforced"] == 1
    _, records_ext = run_in_thread(str(tmp_path / "b.jsonl"), deadline="external")
    assert not [r for r in records_ext if r.get("t") == "deadline_unenforced"]
    assert "deadline_unenforced" not in sweep_status.summarize_sweeps(
        records_ext)["sweeps"]["certify"]


def test_external_deadline_hooks_match_the_jax_executor():
    """``on_cell_start`` is called before every attempt, with the same
    labels and counts as the JAX executor's, on the same failures; under
    ``deadline="external"`` no alarm is armed even on the main thread."""
    calls = {}
    for name, run, opts in (("port", run_cells_resilient, ResilienceOptions),
                            ("jax", jax_run_cells, JaxOptions)):
        seen, timers, failed = [], [], set()

        def cell(payload):
            timers.append(signal.getitimer(signal.ITIMER_REAL)[0])
            if payload["v"] == 1 and payload["v"] not in failed:
                failed.add(payload["v"])
                raise RuntimeError("once")
            if payload["v"] == 2:
                raise RuntimeError("always")
            return {"v": payload["v"]}

        results, _, report = run(
            [(f"c{i}", {"v": i}) for i in range(4)], cell,
            options=opts(attempts=2, cell_deadline_s=5.0, deadline="external",
                         sleep=lambda s: None,
                         on_cell_start=lambda label, cells: seen.append((label, cells))))
        assert timers and all(t == 0.0 for t in timers)
        calls[name] = (seen, results, report.retried, [q["cell"] for q in report.quarantined])
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == [("c0", 1), ("c1", 1), ("c1", 1), ("c2", 1), ("c2", 1), ("c3", 1)]
    with pytest.raises(ValueError):
        ResilienceOptions(deadline="sometimes")


# -- simulate, certify and a dead device through the pool ------------------------------


class _Pipe:
    def __init__(self):
        self.frames = []

    def send(self, ev):
        self.frames.append(json.loads(json.dumps(ev, default=str)))


def test_served_cell_in_a_worker_matches_the_jax_service(tmp_path, monkeypatch):
    """The worker's ``_execute`` of a K=10 MLP cell (ALIE + trimmed mean):
    the JAX service's reply's keys and types, and its loss within
    ``rtol=1e-4, atol=1e-5`` when the port is handed the JAX run's initial
    parameters and round batches; its frames are the JAX worker's kinds."""
    import torch

    from blades_tpu.core.engine import RoundEngine as JaxRoundEngine
    from blades_tpu.datasets.fl import FLDataset as JaxFL
    from blades_tpu.service.server import SimulationService as JaxService
    from blades_tpu_torch.core.engine import RoundEngine
    from blades_tpu_torch.datasets.fl import FLDataset
    from blades_tpu_torch.models import params_from_jax

    import jax

    inits, batches = [], []
    j_init, j_sample = JaxRoundEngine.init, JaxFL.sample_round

    def record_init(self, params, *a, **kw):
        inits.append(jax.tree_util.tree_map(np.asarray, params))
        return j_init(self, params, *a, **kw)

    def record_sample(self, *a, **kw):
        cx, cy = j_sample(self, *a, **kw)
        batches.append((np.asarray(cx), np.asarray(cy)))
        return cx, cy

    monkeypatch.setattr(JaxRoundEngine, "init", record_init)
    monkeypatch.setattr(JaxFL, "sample_round", record_sample)
    jax_reply = JaxService(str(tmp_path / "jax"))._execute("r1", SIM_REQUEST)
    assert jax_reply["ok"], jax_reply

    p_init = RoundEngine.init
    handed = list(batches)
    monkeypatch.setattr(RoundEngine, "init", lambda self, params: p_init(
        self, params_from_jax(inits[0], self.layout)))
    monkeypatch.setattr(FLDataset, "sample_round", lambda self, *a, **kw: tuple(
        torch.from_numpy(np.array(t)) for t in handed.pop(0)))
    pipe = _Pipe()
    state = {"cache": None, "datasets": {}, "out_dir": str(tmp_path / "port"), "device": "cpu"}
    done = worker_mod._execute("r1", SIM_REQUEST, {"attempts": 2}, state, pipe,
                               threading.Event())
    reply = done["reply"]
    assert reply["ok"] and not handed, reply

    def shape(x):
        if isinstance(x, dict):
            return {k: shape(v) for k, v in x.items()}
        if isinstance(x, list):
            return [shape(v) for v in x]
        return type(x).__name__

    assert shape(reply) == shape(jax_reply)
    ours, theirs = reply["cells"][0]["result"], jax_reply["cells"][0]["result"]
    for key in ("label", "agg", "finite"):
        assert ours[key] == theirs[key]
    np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-4, atol=1e-5)
    assert reply["summary"] == jax_reply["summary"]
    kinds = [f["ev"] for f in pipe.frames]
    assert kinds == ["cell_start", "record"] and pipe.frames[1]["type"] == "sweep"
    # the engine's build rode the worker's counters: the request is cold
    assert done["counters"]["engine.builds"] == 1 and done["cache"]["misses"] == 1


def test_pool_serves_simulate_certify_and_probe_requests(tmp_path, capsys):
    """``serve start --workers 2 --device cpu``: a simulate cell bit for
    bit the in-process server's, cold then warm on the same worker (the
    worker's counters: the engine's build, then none); the certify driver
    through ``--via-service``, its verdicts those of an in-process run;
    a probe request; zero survivors at the drain."""
    from blades_tpu_torch.examples import certify

    inproc = SimulationService(str(tmp_path / "inproc"), device="cpu")._execute(
        "x", SIM_REQUEST)
    argv = ["--quick", "--clients", "6", "--aggs", "mean", "median", "--out",
            str(tmp_path / "c")]
    out, proc, client = _start(tmp_path, "pool2", "--workers", "2")
    try:
        cold = client.submit(SIM_REQUEST, request_id="cold", timeout=300)
        warm = client.submit(SIM_REQUEST, request_id="warm", timeout=300)
        probe = client.submit({"kind": "probe", "cells": [{"label": "p", "op": "ok"}]})
        rc = certify.main(argv + ["--via-service", socket_path_for(out)])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    finally:
        rc_srv, stdout, err = _finish(proc, client)
    assert rc_srv == 0, err[-2000:]
    assert cold["ok"] and warm["ok"] and probe["ok"], (cold, warm)
    assert cold["cells"] == warm["cells"] == inproc["cells"]
    fin = {r["id"]: r for r in _finished(out)}
    assert fin["cold"]["warm"] is False and fin["cold"]["compiles"] == 1
    assert fin["warm"]["warm"] is True and fin["warm"]["build_s"] == 0
    assert fin["cold"]["worker"] == fin["warm"]["worker"]
    assert rc == 0 and summary["ok"] is True and summary["via_service"] is True
    served = json.loads((tmp_path / "c" / "cert_matrix.json").read_text())
    local = certify.certify_matrix(certify.parse_args(argv + ["--device", "cpu"]))
    for key in ("cells", "async_cells"):
        assert [(r["agg"], r["f"], r["certified"]) for r in served[key]] == [
            (r["agg"], r["f"], r["certified"]) for r in local[key]]
    shutdown = [r for r in _trace(out) if r.get("event") == "pool_shutdown"]
    assert shutdown and shutdown[0]["survivors"] == []
    assert validate_records(_trace(out)) == []


_LOSE_DEVICE = '''
import os
from blades_tpu_torch.service import handlers
from blades_tpu_torch.sweeps import resilient

_run, _lost = handlers._run_probe, []

def _run_probe(payload):
    once = os.environ["LOSE_DEVICE_ONCE"]
    if payload.get("label") == "lost" and not os.path.exists(once):
        open(once, "w").close()
        _lost.append(1)
        raise RuntimeError("an illegal memory access was encountered")
    return _run(payload)

def probe_device():
    if _lost:
        raise RuntimeError("CUDA error: the context is dead")

handlers._run_probe = _run_probe
resilient.probe_device = probe_device
'''


def test_device_lost_ends_the_worker_and_is_salvaged(tmp_path):
    """A cell whose failure leaves the device dead (the executor's
    ``DeviceLost``): the worker sends no ``done`` and exits with
    ``DEVICE_LOST_EXIT``; the parent reaps it as a crash, and a fresh
    worker recovers the journaled cell, runs the rest, and the reply
    equals an undisturbed run's."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_LOSE_DEVICE)
    once = tmp_path / "lost.once"
    request = {"kind": "probe", "cells": [
        {"label": "c0", "op": "ok", "value": 0},
        {"label": "lost", "op": "ok", "value": 1},
        {"label": "c2", "op": "ok", "value": 2},
    ]}
    os.environ["LOSE_DEVICE_ONCE"] = str(once)
    try:
        out, proc, client = _start(tmp_path, "lost", "--workers", "1", extra_path=str(site))
        try:
            reply = client.submit(request, request_id="lost", timeout=120)
            again = client.submit(request, request_id="again", timeout=120)
            workers = client.status().get("workers") or {}
        finally:
            rc, _, err = _finish(proc, client)
    finally:
        os.environ.pop("LOSE_DEVICE_ONCE", None)
    assert rc == 0, err[-2000:]
    assert once.exists()
    assert reply["ok"] and reply["cells"] == again["cells"]
    summary = reply["summary"]
    assert summary["resumed_skipped"] == 1 and summary["executed"] == 2
    assert summary["quarantined"] == [] and workers["restarts"] == 1
    crash = [r for r in _trace(out) if r.get("t") == "worker" and r.get("event") == "crash"]
    assert len(crash) == 1 and crash[0]["cell"] == "lost" and crash[0]["request"] == "lost"
    # the dead worker wrote the DeviceLost line and nothing else answered
    errs = (tmp_path / "lost" / "workers" / "w0.err").read_text()
    assert "DeviceLost" in errs
    assert worker_mod.DEVICE_LOST_EXIT == 3
