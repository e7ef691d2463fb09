"""The port's run-record readers (``blades_tpu_torch/examples/trace_summary.py``,
``runs.py``, ``sweep_status.py``) against the JAX package's
(``scripts/trace_summary.py``, ``scripts/runs.py``,
``scripts/sweep_status.py``, imported from ``scripts/`` as
``tests/test_telemetry.py`` does) on records the port writes here:

- telemetry traces of port ``Simulator`` runs: a sync round with the
  defense's diagnostics, the audit and the metric pack; a round block; a
  streaming round; an async round; ``summarize`` dicts equal,
  ``format_table`` and ``compare_format`` texts equal;
- a port sweep trace (the resilient executor, resumed, with retries and
  quarantines) and a port service trace (a server answering probe
  requests), registered in a port ledger: ``sweep_status`` and ``runs``
  (``--run-id`` and the summary) print equal JSON lines once the ages,
  which read the clock, are dropped;
- ``--compare`` refuses traces whose config fingerprints differ unless
  ``--force``, as ``tests/test_run_identity.py`` shows for JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from blades_tpu_torch.examples import runs as port_runs
from blades_tpu_torch.examples import sweep_status as port_status
from blades_tpu_torch.examples import trace_summary as port_ts
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import runs as jax_runs  # noqa: E402  (scripts/runs.py)
import sweep_status as jax_status  # noqa: E402  (scripts/sweep_status.py)
import trace_summary as jax_ts  # noqa: E402  (scripts/trace_summary.py)

K = 8


def _run(log_path, seed=0, rounds=2, attack="alie", **run_kw):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    sim = Simulator(Synthetic(num_clients=K, train_size=400, test_size=80, cache=False),
                    attack=attack, num_byzantine=2, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": 2}, seed=seed, device="cpu",
                    log_path=str(log_path))
    sim.run("mlp", global_rounds=rounds, train_batch_size=8, validate_interval=rounds,
            **run_kw)
    return os.path.join(str(log_path), "telemetry.jsonl")


def _own_runs(mp):
    """No run identity in the environment: each run below mints its own
    (one left by an earlier test would read as inherited and be shared by
    every run, so one run's trail would hold the others' traces)."""
    mp.delenv("BLADES_RUN_ID", raising=False)
    mp.delenv("BLADES_ATTEMPT", raising=False)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """The port's telemetry traces, by kind."""
    from blades_tpu_torch.audit import AuditMonitor

    base = tmp_path_factory.mktemp("traces")
    with pytest.MonkeyPatch.context() as mp:
        _own_runs(mp)
        mp.setenv("BLADES_LEDGER", str(base / "ledger.jsonl"))
        return {
            "sync": _run(base / "sync", collect_diagnostics=True, round_metrics=True,
                         audit_monitor=AuditMonitor(fallback_aggregator="median")),
            "sync_seed1": _run(base / "sync_seed1", seed=1, collect_diagnostics=True,
                               round_metrics=True,
                               audit_monitor=AuditMonitor(fallback_aggregator="median")),
            "block": _run(base / "block", rounds=4, block_size=2, collect_diagnostics=True),
            # ALIE reads the whole population: the streaming round refuses it
            "streaming": _run(base / "streaming", attack="signflipping", streaming=True,
                              client_chunks=2),
            "async": _run(base / "async", rounds=3, async_config={
                "buffer_m": 4, "arrivals": {"kind": "uniform", "max_delay": 2},
                "staleness": "polynomial"}),
        }


@pytest.mark.parametrize("kind", ["sync", "block", "streaming", "async"])
def test_summarize_and_format_table_equal_the_jax_readers(traces, kind):
    records = port_ts.load_records(traces[kind])
    assert records == jax_ts.load_records(traces[kind])
    ours, theirs = port_ts.summarize(records), jax_ts.summarize(records)
    assert ours == theirs
    assert port_ts.format_table(ours) == jax_ts.format_table(theirs)
    assert ours["rounds"]["count"] >= 2


def test_the_sync_trace_carries_what_the_readers_report(traces):
    """The sections the slice's trace table reads are there: the round's
    split, the dispatch share, the provenance, the defense and the audit."""
    s = port_ts.summarize(port_ts.load_records(traces["sync"]))
    assert {"round", "round/sample", "round/dispatch", "round/sync"} <= set(s["spans"])
    assert 0.0 <= s["defense"]["mean_byz_trim_frac"] <= 1.0
    # the provenance section may be empty: a warm reuse is reported once a
    # process, and an earlier test may have run the same programs
    assert s["audit"] and "provenance" in s and s["run"]["config_fingerprint"]
    assert "dispatch" in s


@pytest.mark.parametrize("pair", [("sync", "block"), ("streaming", "async"),
                                  ("sync", "sync_seed1")])
def test_compare_format_equals_the_jax_reader(traces, pair):
    a, b = (port_ts.summarize(port_ts.load_records(traces[n])) for n in pair)
    assert port_ts.compare_format(a, b, la=pair[0], lb=pair[1]) == jax_ts.compare_format(
        a, b, la=pair[0], lb=pair[1])


def _main(mod, argv):
    """``mod.main(argv)``'s return code and standard output and error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_compare_refuses_a_fingerprint_mismatch_unless_forced(traces):
    """The sync runs at seeds 0 and 1 are different experiments: refused
    (exit 2, nothing on stdout) by both readers; with ``--force`` compared
    with a warning. The same trace twice compares without one."""
    argv = ["--compare", traces["sync"], traces["sync_seed1"]]
    for mod in (port_ts, jax_ts):
        rc, out, err = _main(mod, argv)
        assert rc == 2 and out == "" and "REFUSING" in err
    forced = [_main(mod, argv + ["--force"]) for mod in (port_ts, jax_ts)]
    assert forced[0] == forced[1] and forced[0][0] == 0 and "WARNING" in forced[0][2]
    same = [_main(mod, ["--compare", traces["sync"], traces["sync"], "--json"])
            for mod in (port_ts, jax_ts)]
    assert same[0] == same[1] and same[0][0] == 0 and same[0][2] == ""
    assert json.loads(same[0][1])["a"] == json.loads(same[0][1])["b"]


def test_single_trace_json_and_table_equal_the_jax_readers(traces):
    for argv in ([traces["sync"]], [traces["sync"], "--json"]):
        assert _main(port_ts, argv) == _main(jax_ts, argv)


# -- the sweep and service traces, through the ledger --------------------------------


def _sweep_run(out_dir):
    """A port sweep of 6 cells through the resilient executor: one cell
    journaled before, resumed; cells c1 and c4 raise every attempt (retried,
    bisected, quarantined)."""
    from blades_tpu_torch import sweeps
    from blades_tpu_torch.sweeps.journal import SweepJournal
    from blades_tpu_torch.sweeps.resilient import ResilienceOptions, run_grouped_resilient
    from blades_tpu_torch.telemetry import context, ledger, set_recorder
    from blades_tpu_torch.telemetry.timeline import SweepAccounting

    def ok(label):
        return {"worst_dev": 1.0, "label": label}

    def runner(group, key):
        bad = [c.label for c in group if c.label in ("c1", "c4")]
        if bad:
            raise KeyError(",".join(bad))
        return [ok(c.label) for c in group]

    trace, jpath = str(out_dir / "sweep_trace.jsonl"), str(out_dir / "journal.jsonl")
    # its records in its own trace, as the certify driver sets them up
    # (examples/certify.py:main)
    context.activate(fresh=True)
    j = SweepJournal(jpath, fingerprint="fp")
    j.record("c0", ok("c0"))
    j.close()
    sw = SweepAccounting("certify", total=6, path=trace)
    prev = set_recorder(sw.rec)
    try:
        entry = ledger.run_started("certify", config={"cells": 6}, artifacts=[trace])
        journal = SweepJournal(jpath, fingerprint="fp", resume=True)
        sw.resume(len(journal), journal=journal.path)
        cells = [sweeps.SweepCell(f"c{i}", agg=None, trials=torch.zeros(1, 4, 2), f=0)
                 for i in range(6)]
        run_grouped_resilient(cells, sweep=sw, journal=journal, options=ResilienceOptions(
            runner=runner, base_delay_s=0.0, sleep=lambda s: None, attempts=3))
        journal.close()
        entry.ended(metrics={"cells": 6})
    finally:
        set_recorder(prev)
        sw.close()
    return entry.record["run_id"]


def _service_run(out_dir, ledger_path):
    """A port server (its own process) answering three probe requests,
    one cell of them failing, then drained; returns its run id."""
    from blades_tpu_torch.service.client import ServiceClient

    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "BLADES_RESUME")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(worker_threads()),
               BLADES_LEDGER=ledger_path)
    proc = subprocess.Popen([sys.executable, "-m", "blades_tpu_torch.examples.serve", "start",
                             "--out", str(out_dir), "--base-delay", "0.05"], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = ServiceClient(str(out_dir / "service.sock"), timeout=60,
                               connect_retries=100, connect_delay_s=0.1)
        client.submit({"kind": "probe", "cells": [{"label": "a", "op": "ok"}]},
                      request_id="r1")
        client.submit({"kind": "probe", "cells": [{"label": "good", "op": "ok"},
                                                  {"label": "bad", "op": "fail",
                                                   "message": "poison"}]},
                      request_id="r2")
        client.submit({"kind": "probe", "cells": [{"label": "c", "op": "ok"}]},
                      request_id="r3")
        client.metrics()
        client.drain()
        _, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    from blades_tpu_torch.telemetry.ledger import read_ledger

    return next(r["run_id"] for r in read_ledger(ledger_path) if r.get("kind") == "service")


@pytest.fixture(scope="module")
def ledger_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ledger")
    ledger_path = str(base / "ledger.jsonl")
    (base / "sweep").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        _own_runs(mp)
        mp.setenv("BLADES_LEDGER", ledger_path)
        sweep_id = _sweep_run(base / "sweep")
        _run(base / "sim")
        mp.delenv("BLADES_RUN_ID", raising=False)  # the server mints its own
        service_id = _service_run(base / "service", ledger_path)
    return {"ledger": ledger_path, "sweep": sweep_id, "service": service_id,
            "sweep_dir": str(base / "sweep"), "service_dir": str(base / "service")}


def _drop_ages(x):
    """``x`` without the ages (``*_age_s``), which read the clock."""
    if isinstance(x, dict):
        return {k: _drop_ages(v) for k, v in x.items() if not k.endswith("_age_s")}
    if isinstance(x, list):
        return [_drop_ages(v) for v in x]
    return x


def _line(mod, argv):
    rc, out, _ = _main(mod, argv)
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 1, out
    return _drop_ages(json.loads(lines[0]))


@pytest.mark.parametrize("which", ["sweep_dir", "service_dir"])
def test_sweep_status_equals_the_jax_script(ledger_runs, which):
    ours = _line(port_status, [ledger_runs[which]])
    assert ours == _line(jax_status, [ledger_runs[which]])
    assert ours["ok"] is True
    if which == "sweep_dir":
        fam = ours["sweeps"]["certify"]
        assert fam["quarantined"] == 2 and fam["resumed_skipped"] == 1 and fam["done"] == 6
    else:
        assert ours["service"]["served"] == 3
        assert ours["service"]["requests"]["by_outcome"] == {"ok": 2, "quarantined": 1}


@pytest.mark.parametrize("which", [None, "sweep", "service"])
def test_runs_equals_the_jax_script(ledger_runs, which):
    argv = ["--ledger", ledger_runs["ledger"]]
    if which:
        argv += ["--run-id", ledger_runs[which]]
    ours = _line(port_runs, argv)
    assert ours == _line(jax_runs, argv)
    assert ours["ok"] is True
    if which is None:
        assert ours["by_kind"] == {"certify": 1, "simulator": 1, "service": 1, "request": 3}
    elif which == "sweep":
        assert ours["found"] and ours["sweep_progress"]["cells_completed"] == 6
        assert ours["sweep_progress"]["quarantined"] == 2
    else:
        assert ours["found"] and ours["service_health"]["served"] == 3


def test_the_readers_keep_the_one_line_contract_on_failure(tmp_path):
    """A missing trace is one ``ok: false`` line with exit 1, as in JAX."""
    missing = str(tmp_path / "nope")
    rc, out, _ = _main(port_status, [missing])
    assert rc == 1 and json.loads(out)["ok"] is False
    assert (rc, out) == _main(jax_status, [missing])[:2]
