"""The simulation service of the port (``blades_tpu_torch/service/``) end to
end on the CPU, against the JAX package's (``blades_tpu/service/``).

- **Cross-talk**: the JAX package's client drives a port server and the
  port's client a JAX server (``scripts/serve.py start``) through the same
  script of probe requests and inline ops; the replies are equal once ids,
  times, pids and run ids are dropped. The JAX package's
  ``scripts/sweep_status.py`` and ``scripts/runs.py --run-id``, unchanged,
  read each server's trace and ledger into equal service blocks.
- The service drills (``examples/chaos.py:service_chaos``, full: the
  reduced set and the supervised SIGKILL resume) pass on the port.
- A server that served only probe cells, a failing one among them, never
  imported torch, and neither did the ledger, the sweeps package, the
  journal or the resilient executor.
- ``simulate`` on the CPU: a served MLP cell equals a direct port
  ``Simulator`` run of the same payload bit for bit; the repeat is warm
  (an ``EngineCache`` hit, ``build_s`` 0) after a cold first request, and
  each split tiles its ``total_s``; the reply has the JAX service's keys,
  types, ``label``, ``agg`` and ``finite``, and its loss is within
  ``rtol=1e-4, atol=1e-5`` of the JAX service's when the port is handed
  the JAX run's initial parameters and round batches.
- A preempted sweep (``ResilienceOptions(should_yield=...)``) resumes from
  its journal to the uninterrupted result, as the JAX executor does.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from blades_tpu.service.client import ServiceClient as JaxClient
from blades_tpu.sweeps.journal import SweepJournal as JaxJournal
from blades_tpu.sweeps.resilient import ResilienceOptions as JaxOptions
from blades_tpu.sweeps.resilient import run_cells_resilient as jax_run_cells
from blades_tpu_torch.examples import chaos
from blades_tpu_torch.service import handlers
from blades_tpu_torch.service.client import ServiceClient
from blades_tpu_torch.service.server import SimulationService
from blades_tpu_torch.sweeps.journal import SweepJournal
from blades_tpu_torch.sweeps.resilient import ResilienceOptions, run_cells_resilient
from blades_tpu_torch.telemetry.schema import validate_records
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: reply and record fields that differ between two runs of one script
_VOLATILE = {"id", "pid", "run_id", "ts", "last_used", "socket", "out", "trace",
             "ledger", "last_event_ts", "last_ts"}


def _norm(x):
    """``x`` with ids, times, pids and run ids dropped."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()
                if k not in _VOLATILE and not k.endswith("_s") and not k.endswith("_share")}
    if isinstance(x, list):
        return [_norm(v) for v in x]
    return x


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "BLADES_RESUME", "BLADES_SWEEP_KILL_AT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(worker_threads()), JAX_PLATFORMS="cpu",
               **extra)
    return env


def _script(client):
    """One fixed script of requests; the replies in order."""
    out = [client.ping()]
    out.append(client.submit({"kind": "probe", "cells": [{"label": "a", "op": "ok",
                                                          "value": 1}]}, request_id="p1"))
    out.append(client.submit({"kind": "probe", "cells": [
        {"label": "good", "op": "ok", "value": [1, 2]},
        {"label": "bad", "op": "fail", "message": "poison"},
        {"op": "ok"}]}, request_id="p2"))
    out.append(client.submit({"kind": "probe", "cells": [{"label": "i", "op": "ok"}]},
                             request_id="p3", client="alice", priority="interactive"))
    out.append(client.submit({"kind": "probe", "cells": [{"label": "zzz", "op": "ok"}]},
                             request_id="p1"))
    out.append(client.result("p2"))
    out.append(client.result("nope"))
    out.append(client.submit({"kind": "probe", "cells": [{}]}, request_id="../x"))
    out.append(client.submit({"kind": "probe", "cells": [{}]}, priority="urgent"))
    out.append(client.submit({"kind": "probe", "cells": [{}]}, client="bad client"))
    out.append(client.submit({"kind": "bogus", "cells": [{}]}, request_id="p5"))
    out.append(client.request({"op": "bogus"}))
    out.append(client.request({"op": "submit"}))
    out.append(client.submit({"kind": "probe", "cells": [{"label": "w", "op": "ok"}]},
                             request_id="p4", wait=False))
    out.append(client.wait_result("p4", timeout=30))
    out.append(client.status())
    out.append(client.metrics())
    out.append(client.drain())
    return out


@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """The script run by the JAX client against a port server and by the
    port's client against a JAX server: replies, output dirs, ledgers."""
    base = tmp_path_factory.mktemp("crossed")
    runs = {}
    for name, argv, client_cls in (
            ("port", [sys.executable, "-m", "blades_tpu_torch.examples.serve", "start"],
             JaxClient),
            ("jax", [sys.executable, os.path.join(ROOT, "scripts", "serve.py"), "start"],
             ServiceClient)):
        out = str(base / name)
        ledger = str(base / f"{name}_ledger.jsonl")
        proc = subprocess.Popen(argv + ["--out", out, "--base-delay", "0.05"], cwd=ROOT,
                                env=_env(BLADES_LEDGER=ledger), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            client = client_cls(os.path.join(out, "service.sock"), timeout=60,
                                connect_retries=100, connect_delay_s=0.1)
            replies = _script(client)
            stdout, stderr = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, stderr
        runs[name] = {"replies": replies, "out": out, "ledger": ledger,
                      "summary": json.loads(stdout.strip().splitlines()[-1])}
    return runs


def test_jax_client_and_port_server_and_back_give_equal_replies(crossed):
    port, jax_ = crossed["port"]["replies"], crossed["jax"]["replies"]
    assert len(port) == len(jax_)
    for a, b in zip(port, jax_):
        assert _norm(a) == _norm(b)
    # the script did what it says on both sides
    assert port[2]["status"] == "done" and port[2]["ok"] is False
    assert port[4]["served"] == "spool" and port[6]["status"] == "unknown"
    assert port[15]["served"] == 4 and port[15]["failed"] == 1
    assert port[15]["quarantined_requests"] == 1
    assert port[16]["requests"]["rejected"] == 0 and port[17]["draining"] is True
    summary = {k: v for k, v in crossed["port"]["summary"].items() if k != "device"}
    assert _norm(summary) == _norm(crossed["jax"]["summary"])


def test_port_service_trace_follows_the_schema(crossed):
    records = [json.loads(line) for line in
               open(os.path.join(crossed["port"]["out"], "service_trace.jsonl"))]
    assert validate_records(records) == []
    kinds = {r["t"] for r in records}
    assert {"meta", "service", "request", "sweep", "metrics_snapshot",
            "cache_stats"} <= kinds


def _tool(*argv):
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_jax_trace_readers_report_the_ports_service_as_the_jaxs(crossed):
    """``scripts/sweep_status.py`` on the trace and ``scripts/runs.py
    --run-id`` on the ledger: the service block (queue depth, served,
    rejected, quarantined, the request rollup) of the port's server equals
    the JAX server's."""
    blocks = {}
    for name, run in crossed.items():
        status = _tool(os.path.join(ROOT, "scripts", "sweep_status.py"), run["out"])
        run_id = run["replies"][0]["run_id"]
        runs = _tool(os.path.join(ROOT, "scripts", "runs.py"), "--ledger", run["ledger"],
                     "--run-id", run_id)
        assert runs["found"] is True
        blocks[name] = (_norm(status["service"]), _norm(runs["service_health"]),
                        _norm(status["sweeps"]))
    assert blocks["port"] == blocks["jax"]
    service = blocks["port"][0]
    assert service["served"] == 4 and service["rejected"] == 0
    assert service["quarantined_requests"] == 1 and service["requests"]["pending"] == 0
    assert service["requests"]["by_outcome"] == {"ok": 3, "error": 1, "quarantined": 1}


def test_service_drills_and_sigkill_resume_on_the_port(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", str(worker_threads()))
    # a short base directory: each drill's socket path must stay within
    # the 108 bytes a unix socket's path may take
    summary = chaos.service_chaos(str(tmp_path_factory.mktemp("d")), full=True)
    rows = {r["name"]: r for r in summary["scenarios"]}
    assert summary["ok"], summary
    assert set(rows) == {"poison_isolated", "backpressure", "deadline_hang", "drain_no_loss",
                         "tenant_flood", "preempt_resume", "worker_crash", "worker_hang",
                         "sigkill_resume"}
    kill = rows["sigkill_resume"]
    assert kill["content_identical"] and kill["resumed_skipped"] == 2 and kill["executed"] == 2


_NO_TORCH_SERVER = r"""
import json, sys, threading
from blades_tpu_torch.telemetry import ledger
from blades_tpu_torch import sweeps
from blades_tpu_torch.sweeps import journal, resilient
assert 'torch' not in sys.modules, 'import'
def boom(payload):
    raise RuntimeError('no')
res, _, rep = resilient.run_cells_resilient(
    [('x', {})], boom, options=resilient.ResilienceOptions(sleep=lambda s: None))
assert res == [None] and rep.quarantined and 'torch' not in sys.modules, 'probe'
from blades_tpu_torch.service.client import ServiceClient
from blades_tpu_torch.service.server import SimulationService
svc = SimulationService(sys.argv[1], base_delay_s=0.0)
replies = []
def drive():
    c = ServiceClient(svc.socket_path, connect_retries=100, connect_delay_s=0.05)
    replies.append(c.submit({'kind': 'probe', 'cells': [{'label': 'ok', 'op': 'ok'},
                                                       {'label': 'bad', 'op': 'fail'}]}))
    replies.append(c.drain())
t = threading.Thread(target=drive)
t.start()
svc.serve()
t.join()
print(json.dumps({'replies': replies, 'torch': 'torch' in sys.modules,
                  'numpy': 'numpy' in sys.modules}))
"""


def test_probe_only_server_never_imports_torch(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH_SERVER, str(tmp_path / "svc")],
                          cwd=ROOT, env=_env(BLADES_LEDGER=str(tmp_path / "l.jsonl")),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    cells = {c["label"]: c for c in out["replies"][0]["cells"]}
    assert "result" in cells["ok"] and cells["bad"]["quarantined"]
    assert out["torch"] is False and out["numpy"] is False


# -- simulate on the CPU ------------------------------------------------------------

PAYLOAD = {"label": "m", "agg": "trimmedmean", "agg_kws": {"num_byzantine": 2},
           "attack": "alie", "num_byz": 2, "rounds": 2, "seed": 1}
REQUEST = {"kind": "simulate", "cells": [PAYLOAD]}


def _direct_run(tmp_path):
    """The payload through a port Simulator built here, hashed as the
    service hashes it."""
    import hashlib

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.ops.pytree import ravel

    scn = {**handlers._SIM_DEFAULTS, **PAYLOAD}
    sim = Simulator(Synthetic(num_clients=scn["clients"], train_size=scn["train_size"],
                              test_size=scn["test_size"], noise=0.3, cache=False),
                    aggregator="trimmedmean", aggregator_kws={"num_byzantine": 2},
                    attack="alie", num_byzantine=2, log_path=str(tmp_path / "direct"),
                    seed=scn["seed"], device="cpu")
    sim.run("mlp", global_rounds=scn["rounds"], local_steps=1,
            train_batch_size=scn["train_batch_size"], client_lr=scn["client_lr"],
            server_lr=1.0, validate_interval=scn["rounds"])
    params = ravel(sim.server.state.params, sim.engine.layout).to(torch.float32).numpy()
    ev = sim.evaluate(scn["rounds"], 64)
    return {"loss": round(float(ev["Loss"]), 6),
            "params_sha": hashlib.sha256(params.tobytes()).hexdigest()[:16]}


def test_served_cell_is_the_direct_run_and_the_repeat_is_warm(tmp_path):
    """The port's form of the JAX ``test_warm_serving_zero_compiles``."""
    svc = SimulationService(str(tmp_path / "svc"), device="cpu")
    first = svc._execute("r1", REQUEST)
    second = svc._execute("r2", REQUEST)
    assert first["ok"] and second["ok"], (first, second)
    assert first["cells"] == second["cells"]
    cell = first["cells"][0]["result"]
    assert {k: cell[k] for k in ("loss", "params_sha")} == _direct_run(tmp_path)
    assert cell["finite"] is True
    assert svc._engine_cache.stats()["hits"] == 1 and svc._engine_cache.stats()["misses"] == 1
    m = svc.metrics.snapshot()
    assert m["requests"]["cold"] == 1 and m["requests"]["warm"] == 1
    split = m["split"]
    assert abs(split["queue_wait_s"] + split["build_s"] + split["execute_s"]
               - split["total_s"]) < 1e-4
    svc.rec.flush()
    recs = [json.loads(line) for line in open(tmp_path / "svc" / "service_trace.jsonl")]
    fin = {r["id"]: r for r in recs if r["t"] == "request" and r.get("event") == "finished"}
    assert fin["r1"]["warm"] is False and fin["r1"]["build_s"] > 0
    assert fin["r1"]["compiles"] == 1  # the engine's build
    assert fin["r2"]["warm"] is True and fin["r2"]["build_s"] == 0
    assert fin["r2"]["compiles"] == 0
    for r in fin.values():
        assert abs(r["queue_wait_s"] + r["build_s"] + r["execute_s"] - r["total_s"]) < 1e-4
    assert validate_records(recs) == []


def test_a_cuda_server_without_cuda_fails_the_cell_not_the_server(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = SimulationService(str(tmp_path / "svc"))
    reply = svc._execute("r1", REQUEST)
    assert reply["status"] == "done" and reply["ok"] is False
    assert reply["cells"][0]["quarantined"] and "cuda" in reply["cells"][0]["error"].lower()
    sweep = svc._execute("r2", {"kind": "sweep", "sweep": "certify", "spec": {"quick": True}})
    assert sweep["status"] == "error" and "cuda" in sweep["error"].lower()
    assert svc._execute("r3", {"kind": "probe", "cells": [{"op": "ok"}]})["ok"] is True


def test_served_cell_matches_the_jax_service_with_its_draws(tmp_path, monkeypatch):
    """The JAX service's reply to the same request: the same keys and
    types, label, agg and finite; the loss within ``rtol=1e-4,
    atol=1e-5`` when the port's Simulator is handed the JAX run's initial
    parameters (its engine's ``init``) and round batches (the sampler)."""
    from blades_tpu.core.engine import RoundEngine as JaxRoundEngine
    from blades_tpu.datasets.fl import FLDataset as JaxFL
    from blades_tpu.service.server import SimulationService as JaxService
    from blades_tpu_torch.core.engine import RoundEngine
    from blades_tpu_torch.datasets.fl import FLDataset
    from blades_tpu_torch.models import params_from_jax

    inits, batches = [], []
    j_init, j_sample = JaxRoundEngine.init, JaxFL.sample_round

    def record_init(self, params, *a, **kw):
        inits.append(jax_tree_to_numpy(params))
        return j_init(self, params, *a, **kw)

    def record_sample(self, *a, **kw):
        cx, cy = j_sample(self, *a, **kw)
        batches.append((np.asarray(cx), np.asarray(cy)))
        return cx, cy

    monkeypatch.setattr(JaxRoundEngine, "init", record_init)
    monkeypatch.setattr(JaxFL, "sample_round", record_sample)
    jax_reply = JaxService(str(tmp_path / "jax"))._execute("r1", REQUEST)
    assert jax_reply["ok"], jax_reply
    assert len(inits) == 1 and len(batches) == PAYLOAD["rounds"]

    p_init = RoundEngine.init
    handed = list(batches)
    monkeypatch.setattr(RoundEngine, "init",
                        lambda self, params: p_init(self, params_from_jax(inits[0],
                                                                          self.layout)))
    monkeypatch.setattr(FLDataset, "sample_round",
                        lambda self, *a, **kw: tuple(torch.from_numpy(np.array(t))
                                                     for t in handed.pop(0)))
    reply = SimulationService(str(tmp_path / "port"), device="cpu")._execute("r1", REQUEST)
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


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


# -- preemption at a cell boundary ----------------------------------------------------


def _cells(n):
    return [(f"c{i}", {"v": i}) for i in range(n)]


def _value(payload):
    return {"v": payload["v"] * 3}


@pytest.mark.parametrize("yield_after", [1, 2])
def test_preempted_sweep_resumes_to_the_uninterrupted_result(tmp_path, yield_after):
    """A ``should_yield`` that asks after one (or two) cells stops the sweep
    at the boundary with ``preempted`` set and the rest ``None``; a second
    execution on the journal runs only the rest, and the results equal an
    uninterrupted run's. The JAX executor stops at the same cell."""
    full, _, _ = run_cells_resilient(_cells(5), _value)
    reports = {}
    for name, run, journal_cls, options_cls in (
            ("port", run_cells_resilient, SweepJournal, ResilienceOptions),
            ("jax", jax_run_cells, JaxJournal, JaxOptions)):
        path = str(tmp_path / f"{name}.jsonl")
        asked = []

        def should_yield():
            asked.append(1)
            return len(asked) >= yield_after

        journal = journal_cls(path, fingerprint="fp")
        first, _, rep = run(_cells(5), _value, journal=journal,
                            options=options_cls(should_yield=should_yield))
        journal.close()
        assert rep.preempted and rep.executed == yield_after
        assert first[:yield_after] == full[:yield_after]
        assert first[yield_after:] == [None] * (5 - yield_after) and not rep.quarantined
        journal = journal_cls(path, fingerprint="fp", resume=True)
        second, _, rep2 = run(_cells(5), _value, journal=journal,
                              options=options_cls(should_yield=lambda: True))
        journal.close()
        # the resumed slice yields again after one new cell
        assert rep2.resumed_skipped == yield_after and rep2.executed == 1
        journal = journal_cls(path, fingerprint="fp", resume=True)
        third, _, rep3 = run(_cells(5), _value, journal=journal)
        journal.close()
        assert third == full and not rep3.preempted
        assert rep3.executed == 5 - yield_after - 1
        reports[name] = [(r.executed, r.resumed_skipped, r.preempted) for r in (rep, rep2, rep3)]
    assert reports["port"] == reports["jax"]


def test_a_quarantined_cell_counts_as_progress_and_recoveries_do_not(tmp_path):
    def run(payload):
        if payload["v"] == 0:
            raise ValueError("poison")
        return _value(payload)

    results, _, rep = run_cells_resilient(
        _cells(3), run, options=ResilienceOptions(sleep=lambda s: None,
                                                  should_yield=lambda: True))
    assert rep.preempted and results == [None, None, None] and len(rep.quarantined) == 1


def test_grouped_executor_yields_at_group_boundaries(tmp_path):
    from blades_tpu_torch.sweeps import SweepCell
    from blades_tpu_torch.sweeps.resilient import run_grouped_resilient

    cells = [SweepCell(label=f"g{i}", agg=f"agg{i % 2}", trials=torch.zeros(1, 4, 2), f=0)
             for i in range(4)]

    def runner(group, key):
        return [{"label": c.label} for c in group]

    results, _, rep = run_grouped_resilient(
        cells, options=ResilienceOptions(runner=runner, should_yield=lambda: True))
    assert rep.preempted and rep.executed == 2
    assert [r and r["label"] for r in results] == ["g0", None, "g2", None]


def test_serve_cli_is_one_json_line_on_error(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "blades_tpu_torch.examples.serve", "status",
                           "--socket", str(tmp_path / "nope.sock"), "--timeout", "5"],
                          cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1 and proc.returncode != 0
    payload = json.loads(lines[0])
    assert payload["ok"] is False and "unreachable" in payload["error"]


def test_listener_answers_while_a_request_runs(tmp_path):
    """``op: status`` names the in-flight request and its age while the
    main thread runs it (the listener never waits for execution)."""
    svc = SimulationService(str(tmp_path / "svc"), base_delay_s=0.0, poll_s=0.05)
    seen = {}

    def drive():
        c = ServiceClient(svc.socket_path, connect_retries=100, connect_delay_s=0.05)
        rid = c.submit({"kind": "probe", "cells": [{"label": "s", "op": "sleep",
                                                    "sleep_s": 2.0}]}, wait=False)["id"]
        for _ in range(100):
            st = c.status()
            if st.get("in_flight_id") == rid:
                seen["status"] = st
                break
            threading.Event().wait(0.02)
        seen["reply"] = c.wait_result(rid, timeout=30)
        c.drain()

    t = threading.Thread(target=drive)
    t.start()
    snap = svc.serve()
    t.join()
    assert seen["status"]["in_flight"] == 1 and seen["status"]["in_flight_age_s"] >= 0
    assert seen["reply"]["reply"]["ok"] and snap["served"] == 1
