"""Resilient sweeps (``sweeps/resilient.py``, ``sweeps/journal.py``,
``utils/retry.py``, ``examples/certify.py --attempts``) against the JAX
package's.

Both executors run the same injected ``runner`` failures on both packages,
and give the same result slots, the same ``ResilienceReport.summary()``,
the same ``retry`` / ``quarantine`` / ``resume`` / ``sweep`` records field
by field (times aside) and the same journal lines. A journal written by
either package loads in the other. The port's own rules: a failed attempt
whose device then fails its probe raises ``DeviceLost`` and journals no
quarantine, and a failed attempt's frames are gone before its retry. The
certify driver's matrix with ``--attempts 2`` matches the JAX package's
(verdicts exactly, ratios at ``rtol=1e-4, atol=1e-6``), and a run killed by
the journal's saboteur and resumed gives the uninterrupted run's matrix.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch

from blades_tpu import sweeps as jax_sweeps_pkg
from blades_tpu.sweeps import journal as jax_journal
from blades_tpu.sweeps import resilient as jax_resilient
from blades_tpu.telemetry import recorder as jax_recorder
from blades_tpu.telemetry import timeline as jax_timeline
from blades_tpu.utils import retry as jax_retry
from blades_tpu_torch import sweeps as port_sweeps_pkg
from blades_tpu_torch.examples import certify
from blades_tpu_torch.sweeps import journal as port_journal
from blades_tpu_torch.sweeps import resilient as port_resilient
from blades_tpu_torch.telemetry import recorder as port_recorder
from blades_tpu_torch.telemetry import timeline as port_timeline
from blades_tpu_torch.telemetry.schema import validate_records
from blades_tpu_torch.utils import retry as port_retry
from torch_threads_helpers import torch_threads_per_worker, worker_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import certify as jax_certify  # noqa: E402  (scripts/certify.py)
from sweep_status import load_sweep_records, summarize_sweeps  # noqa: E402

SEARCH_TOL = dict(rtol=1e-4, atol=1e-6)
#: record fields that are times, the run's identity or a file's path, left
#: out of the record-by-record comparison
_VOLATILE = {"ts", "wall_s", "eta_s", "execute_s", "run_id", "attempt", "pid", "journal"}
_TRAIL = ("retry", "quarantine", "resume", "sweep", "deadline_unenforced")

PKGS = {
    "jax": types.SimpleNamespace(
        SweepCell=jax_sweeps_pkg.SweepCell, Journal=jax_journal.SweepJournal,
        Accounting=jax_timeline.SweepAccounting, Options=jax_resilient.ResilienceOptions,
        grouped=jax_resilient.run_grouped_resilient, cells=jax_resilient.run_cells_resilient,
        trials=lambda: np.zeros((1, 4, 2), np.float32)),
    "port": types.SimpleNamespace(
        SweepCell=port_sweeps_pkg.SweepCell, Journal=port_journal.SweepJournal,
        Accounting=port_timeline.SweepAccounting, Options=port_resilient.ResilienceOptions,
        grouped=port_resilient.run_grouped_resilient, cells=port_resilient.run_cells_resilient,
        trials=lambda: torch.zeros(1, 4, 2)),
}


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _trail(path):
    return [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in _records(path) if r.get("t") in _TRAIL]


def _journal_lines(path):
    return [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in _records(path) if r.get("kind") != "meta"]


def _ok(label):
    return {"worst_dev": 1.0, "label": label}


# -- the injected failures, one scenario each ------------------------------------


def _poison(calls, group):
    labels = [c.label for c in group]
    if "c2" in labels:
        raise ValueError("poison in " + ",".join(labels))
    return [_ok(c.label) for c in group]


def _flaky_once(calls, group):
    if len(calls) == 1:
        raise RuntimeError("transient: backend unavailable")
    return [_ok(c.label) for c in group]


def _slow_groups(calls, group):
    if len(group) > 1:
        time.sleep(0.5)  # past the group's len(group) * 0.02 s deadline
    return [_ok(c.label) for c in group]


def _two_poisons(calls, group):
    bad = [c.label for c in group if c.label in ("c1", "c4")]
    if bad:
        raise KeyError(",".join(bad))
    return [_ok(c.label) for c in group]


GROUPED = {
    "poison": (_poison, {}),
    "flaky_once": (_flaky_once, {}),
    "deadline": (_slow_groups, {"cell_deadline_s": 0.02}),
    "two_poisons": (_two_poisons, {"attempts": 3}),
}


def _grouped_run(pkg, tmp_path, n, fail, opts, journal_path=None, resume=False):
    ns = PKGS[pkg]
    calls = []

    def runner(group, key):
        calls.append([c.label for c in group])
        return fail(calls, group)

    trace = str(tmp_path / f"{pkg}_trace.jsonl")
    sw = ns.Accounting("certify", total=n, path=trace)
    journal = ns.Journal(journal_path or str(tmp_path / f"{pkg}_j.jsonl"), fingerprint="fp",
                         resume=resume)
    if journal.resumed:
        sw.resume(len(journal), journal=journal.path)
    cells = [ns.SweepCell(f"c{i}", agg=None, trials=ns.trials(), f=0) for i in range(n)]
    options = ns.Options(runner=runner, base_delay_s=0.0, sleep=lambda s: None,
                         **{"attempts": 2, **opts})
    results, walls, report = ns.grouped(cells, sweep=sw, journal=journal, options=options)
    sw.close()
    journal.close()
    return dict(results=results, summary=report.summary(), calls=calls, trail=_trail(trace),
                journal=_journal_lines(journal.path), trace=trace, walls=walls)


@pytest.mark.parametrize("scenario", sorted(GROUPED))
def test_grouped_executor_matches_jax(tmp_path, scenario):
    fail, opts = GROUPED[scenario]
    n = 6 if scenario == "two_poisons" else 4
    jax_out = _grouped_run("jax", tmp_path, n, fail, opts)
    port_out = _grouped_run("port", tmp_path, n, fail, opts)
    for key in ("results", "summary", "calls", "trail", "journal"):
        assert port_out[key] == jax_out[key], key
    assert validate_records(_records(port_out["trace"])) == []
    if scenario == "poison":
        assert port_out["summary"]["quarantined"] == ["c2"]
        assert [r and r["label"] for r in port_out["results"]] == ["c0", "c1", None, "c3"]
    if scenario == "deadline":
        assert any("DeadlineExceeded" in r.get("error", "") for r in port_out["trail"]
                   if r["t"] == "retry")


def _cells_run(pkg, tmp_path, labels, run_cell, opts, journal_path=None, resume=False):
    ns = PKGS[pkg]
    trace = str(tmp_path / f"{pkg}_trace.jsonl")
    sw = ns.Accounting("chaos", total=len(labels), path=trace)
    journal = ns.Journal(journal_path or str(tmp_path / f"{pkg}_j.jsonl"), fingerprint="fp",
                         resume=resume)
    if journal.resumed:
        sw.resume(len(journal), journal=journal.path)
    options = ns.Options(base_delay_s=0.0, sleep=lambda s: None, **{"attempts": 2, **opts})
    results, walls, report = ns.cells([(lab, lab) for lab in labels], run_cell, sweep=sw,
                                      journal=journal, options=options, kind="chaos")
    sw.close()
    journal.close()
    return dict(results=results, summary=report.summary(), trail=_trail(trace),
                journal=_journal_lines(journal.path), trace=trace)


def _per_cell(scenario):
    seen = {}

    def run_cell(label):
        seen[label] = seen.get(label, 0) + 1
        if scenario == "flaky_and_poison":
            if label == "b" and seen[label] == 1:
                raise OSError("transient")
            if label == "d":
                raise ZeroDivisionError("poison")
        if scenario == "deadline" and label == "c" and seen[label] == 1:
            time.sleep(0.5)
        return {"label": label, "n": seen[label]}

    return run_cell


@pytest.mark.parametrize("scenario,opts", [("flaky_and_poison", {}),
                                           ("deadline", {"cell_deadline_s": 0.05})])
def test_per_cell_executor_matches_jax(tmp_path, scenario, opts):
    labels = ["a", "b", "c", "d", "e"]
    outs = {pkg: _cells_run(pkg, tmp_path, labels, _per_cell(scenario), opts)
            for pkg in ("jax", "port")}
    for key in ("results", "summary", "trail", "journal"):
        assert outs["port"][key] == outs["jax"][key], key
    assert validate_records(_records(outs["port"]["trace"])) == []
    if scenario == "flaky_and_poison":
        assert outs["port"]["summary"]["quarantined"] == ["d"]
        assert outs["port"]["results"][1] == {"label": "b", "n": 2}


def test_clean_run_matches_plain_run_grouped():
    """With nothing failing, the resilient executor makes the plain
    executor's calls: bit for bit ``run_grouped``'s results, no retry."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.audit import QUICK_GRIDS, battery_ctx, synthetic_honest

    trials = synthetic_honest(torch.Generator().manual_seed(0), 2, 6, 8)
    ctx = battery_ctx(None, 6, 8, generator=torch.Generator().manual_seed(3))
    cells = [
        port_sweeps_pkg.SweepCell("m/f1", get_aggregator("median"), trials, 1, ctx),
        port_sweeps_pkg.SweepCell("tm/f1", get_aggregator("trimmedmean", num_byzantine=1),
                                  trials, 1, ctx),
        port_sweeps_pkg.SweepCell("m/f2", get_aggregator("median"), trials, 2, ctx),
    ]
    plain = port_sweeps_pkg.run_grouped(cells, grids=QUICK_GRIDS)
    resilient, _, report = port_resilient.run_grouped_resilient(cells, grids=QUICK_GRIDS)
    assert resilient == plain
    assert report.retried == 0 and report.quarantined == [] and report.executed == 3


@pytest.mark.parametrize("executor", ["grouped", "cells"])
def test_resume_runs_only_the_remaining_cells_as_jax_does(tmp_path, executor):
    """A journal holding some cells (one quarantined): both packages recover
    them, run the rest, and write the same trail; a complete journal runs
    nothing."""
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}_prefix.jsonl")
        j = PKGS[pkg].Journal(path, fingerprint="fp")
        j.record("c0" if executor == "grouped" else "a", _ok("first"), wall_s=0.5)
        j.record_quarantine("c1" if executor == "grouped" else "b", "ValueError: boom",
                            "ValueError", attempts=2)
        j.close()
    outs = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}_prefix.jsonl")
        if executor == "grouped":
            outs[pkg] = _grouped_run(pkg, tmp_path, 4, lambda calls, g: [_ok(c.label) for c in g],
                                     {}, journal_path=path, resume=True)
        else:
            outs[pkg] = _cells_run(pkg, tmp_path, ["a", "b", "c", "d"], lambda lab: _ok(lab), {},
                                   journal_path=path, resume=True)
    for key in ("results", "summary", "trail", "journal"):
        assert outs["port"][key] == outs["jax"][key], key
    summary = outs["port"]["summary"]
    assert summary["resumed_skipped"] == 2 and summary["executed"] == 2
    if executor == "grouped":
        assert outs["port"]["calls"] == [["c2", "c3"]]
    assert [r["skipped"] for r in outs["port"]["trail"] if r["t"] == "resume"] == [2]

    # the journal is now complete: a second resume runs no cell
    def never(*a):
        raise AssertionError("a complete sweep must not run a cell")

    path = str(tmp_path / "port_prefix.jsonl")
    if executor == "grouped":
        again = _grouped_run("port", tmp_path, 4, never, {}, journal_path=path, resume=True)
    else:
        again = _cells_run("port", tmp_path, ["a", "b", "c", "d"], never, {}, journal_path=path,
                           resume=True)
    assert again["summary"]["executed"] == 0 and again["summary"]["resumed_skipped"] == 4
    assert again["results"] == outs["port"]["results"]


# -- the journal -----------------------------------------------------------------


def test_journal_roundtrip_and_fingerprint_guard(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = port_journal.SweepJournal(path, fingerprint="fp1")
    j.record("a", {"x": 1.5}, wall_s=0.25)
    j.record_quarantine("b", "ValueError: boom", "ValueError", batch="g1", attempts=2)
    j.close()
    r = port_journal.SweepJournal(path, fingerprint="fp1", resume=True)
    assert r.resumed and r.results() == {"a": {"x": 1.5}}
    assert r.entry("a")["wall_s"] == 0.25
    assert r.has("a") and r.has("b") and not r.has("c") and len(r) == 2
    assert r.quarantined()["b"]["error_type"] == "ValueError"
    assert r.quarantined()["b"]["batch"] == "g1"
    assert r.recovered(["c", "b", "a"]) == ["b", "a"]
    r.close()
    f = port_journal.SweepJournal(path, fingerprint="fp2", resume=True)
    assert not f.resumed and f.results() == {} and not f.has("a")
    f.close()


def test_journal_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = port_journal.SweepJournal(path, fingerprint="fp")
    j.record("a", {"x": 1})
    j.record("b", {"x": 2})
    j.close()
    with open(path, "a") as f:
        f.write('{"kind": "cell", "cell": "c", "result": {"x":')
    r = port_journal.SweepJournal(path, fingerprint="fp", resume=True)
    assert r.resumed and sorted(r.results()) == ["a", "b"]
    r.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_written_by_either_package_loads_in_the_other(tmp_path, writer):
    reader = "port" if writer == "jax" else "jax"
    path = str(tmp_path / "j.jsonl")
    w = PKGS[writer].Journal(path, fingerprint="fp")
    w.record("a", {"worst_ratio": 0.25, "templates": {"ipm": [1, 2]}}, wall_s=1.5)
    w.record_quarantine("b", "RuntimeError: oom", "RuntimeError", batch="k", attempts=2)
    w.record("c", [1.0, 2.0])
    w.close()
    r = PKGS[reader].Journal(path, fingerprint="fp", resume=True)
    assert r.resumed
    assert r.results() == {"a": {"worst_ratio": 0.25, "templates": {"ipm": [1, 2]}},
                           "c": [1.0, 2.0]}
    assert r.entry("a")["wall_s"] == 1.5
    q = r.quarantined()["b"]
    assert (q["error"], q["error_type"], q["batch"], q["attempts"]) == (
        "RuntimeError: oom", "RuntimeError", "k", 2)
    r.close()
    other = PKGS[reader].Journal(path, fingerprint="other", resume=True)
    assert not other.resumed and len(other) == 0
    other.close()


def test_journal_saboteur_sigkills_once(tmp_path):
    """``BLADES_SWEEP_KILL_AT=N`` SIGKILLs the process after the N-th line,
    once; the relaunch under resume finishes; a fresh launch re-arms it."""
    path = str(tmp_path / "j.jsonl")
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from blades_tpu_torch.sweeps.journal import SweepJournal\n"
        f"j = SweepJournal({path!r}, fingerprint='fp',\n"
        "                 resume=os.environ.get('BLADES_RESUME') == '1')\n"
        "for i in range(3):\n"
        "    if not j.has(f'c{i}'):\n"
        "        j.record(f'c{i}', {'i': i})\n"
        "print('DONE', len(j))\n"
    )
    env = dict(os.environ, **{port_journal.KILL_AT_ENV: "2"})
    env.pop("BLADES_RESUME", None)
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=60)
    assert p.returncode == -signal.SIGKILL, (p.stdout, p.stderr)
    assert os.path.exists(path + ".kill_fired")
    env["BLADES_RESUME"] = "1"
    p2 = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                        timeout=60)
    assert p2.returncode == 0 and "DONE 3" in p2.stdout, (p2.stdout, p2.stderr)
    env.pop("BLADES_RESUME")
    p3 = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                        timeout=60)
    assert p3.returncode == -signal.SIGKILL, (p3.stdout, p3.stderr)


# -- retry, backoff and deadlines ------------------------------------------------


def test_backoff_delay_equals_jax():
    for attempt in range(13):
        for base, top in ((1.0, 60.0), (0.5, 30.0), (0.1, 2.0)):
            assert port_retry.backoff_delay(attempt, base, top) == jax_retry.backoff_delay(
                attempt, base, top)


def test_retry_call_records_as_jax_does():
    def run(mod, rec_mod):
        rec = rec_mod.Recorder(enabled=True)
        prev = rec_mod.set_recorder(rec)
        tries, slept = [], []

        def flaky():
            tries.append(1)
            if len(tries) < 3:
                raise ConnectionError(f"flake {len(tries)}")
            return "up"

        try:
            out = mod.retry_call(flaky, attempts=4, base_delay=0.5, describe="probe",
                                 sleep=slept.append)
        finally:
            rec_mod.set_recorder(prev)
        with pytest.raises(ValueError):
            mod.retry_call(lambda: 1 / 0, attempts=0)
        return out, slept, rec.counters, [
            {k: v for k, v in r.items() if k not in _VOLATILE}
            for r in rec.records if r["t"] == "retry"]

    assert run(port_retry, port_recorder) == run(jax_retry, jax_recorder)


def test_soft_deadline_trips_and_restores():
    t0 = time.time()
    with pytest.raises(port_resilient.DeadlineExceeded):
        with port_resilient.soft_deadline(0.05):
            time.sleep(5.0)
    assert time.time() - t0 < 2.0
    with port_resilient.soft_deadline(None) as armed:
        assert armed is False
    time.sleep(0.08)  # nothing fires after the block


def test_deadline_off_the_main_thread_is_recorded_as_unenforced(tmp_path):
    """Both packages write one ``deadline_unenforced`` record when SIGALRM
    cannot arm (a worker thread), and run the cells unbounded."""
    trails = {}
    for pkg in ("jax", "port"):
        box = {}
        thread = threading.Thread(target=lambda: box.update(out=_cells_run(
            pkg, tmp_path, ["a", "b"], lambda lab: _ok(lab), {"cell_deadline_s": 1.0})))
        thread.start()
        thread.join(timeout=60)
        assert not thread.is_alive()
        trails[pkg] = box["out"]["trail"]
    assert trails["port"] == trails["jax"]
    assert [r["reason"] for r in trails["port"] if r["t"] == "deadline_unenforced"] == [
        "non_main_thread"]


# -- the port's own rules --------------------------------------------------------


def _device_dies(monkeypatch):
    def probe():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(port_resilient, "probe_device", probe)


def test_dead_device_raises_and_quarantines_nothing_grouped(tmp_path, monkeypatch):
    _device_dies(monkeypatch)
    path = str(tmp_path / "j.jsonl")
    journal = port_journal.SweepJournal(path, fingerprint="fp")
    cells = [port_sweeps_pkg.SweepCell(f"c{i}", agg=None, trials=torch.zeros(1, 4, 2), f=0)
             for i in range(4)]
    calls = []

    def runner(group, key):
        calls.append(len(group))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(port_resilient.DeviceLost, match="BLADES_RESUME"):
        port_resilient.run_grouped_resilient(
            cells, journal=journal,
            options=port_resilient.ResilienceOptions(runner=runner, sleep=lambda s: None))
    journal.close()
    assert calls == [4]  # no retry, no bisection
    assert [r["kind"] for r in _records(path)] == ["meta"]


def test_dead_device_raises_and_a_resume_finishes_clean_per_cell(tmp_path, monkeypatch):
    """The cells before the fault stay journaled; the relaunch (a healthy
    device) recovers them, runs the rest and quarantines nothing."""
    path = str(tmp_path / "j.jsonl")
    journal = port_journal.SweepJournal(path, fingerprint="fp")

    def run_cell(label):
        if label == "c":
            raise RuntimeError("CUDA error: device-side assert triggered")
        return _ok(label)

    with monkeypatch.context() as m:
        _device_dies(m)
        with pytest.raises(port_resilient.DeviceLost):
            port_resilient.run_cells_resilient(
                [(lab, lab) for lab in "abcd"], run_cell, journal=journal,
                options=port_resilient.ResilienceOptions(sleep=lambda s: None))
    journal.close()
    assert [(r["kind"], r.get("cell")) for r in _records(path)] == [
        ("meta", None), ("cell", "a"), ("cell", "b")]
    resumed = port_journal.SweepJournal(path, fingerprint="fp", resume=True)
    results, _, report = port_resilient.run_cells_resilient(
        [(lab, lab) for lab in "abcd"], _ok, journal=resumed,
        options=port_resilient.ResilienceOptions(sleep=lambda s: None))
    resumed.close()
    assert [r["label"] for r in results] == list("abcd")
    assert report.quarantined == [] and report.resumed_skipped == 2 and report.executed == 2


@pytest.mark.parametrize("executor", ["grouped", "cells"])
def test_failed_attempt_frees_its_tensors_before_the_retry(executor):
    """A tensor made in the failed attempt's frame is dead (no reference
    left, no garbage collection run) when the retry starts, so an OOM
    retry finds that memory free."""
    refs, alive_at_retry = [], []

    def attempt():
        if refs:
            alive_at_retry.append(refs[0]() is not None)
            return "done"
        big = torch.ones(1024)
        refs.append(weakref.ref(big))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    import gc

    gc.disable()
    try:
        if executor == "grouped":
            cell = port_sweeps_pkg.SweepCell("c0", agg=None, trials=torch.zeros(1, 4, 2), f=0)
            results, _, report = port_resilient.run_grouped_resilient(
                [cell], options=port_resilient.ResilienceOptions(
                    runner=lambda group, key: [attempt()], sleep=lambda s: None))
        else:
            results, _, report = port_resilient.run_cells_resilient(
                [("c0", None)], lambda _: attempt(),
                options=port_resilient.ResilienceOptions(sleep=lambda s: None))
    finally:
        gc.enable()
    assert results == ["done"] and report.retried == 1
    assert alive_at_retry == [False]


# -- the certify driver ------------------------------------------------------------


def _cert_args(**kw):
    base = dict(clients=8, dim=32, trials=3, seed=0, c=None, aggs=["mean", "median", "trimmedmean"],
                quick=True, no_async=True, tau_max=3, no_jit=False, sequential=False,
                out="unused", attempts=2, cell_deadline=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_certify_main_with_attempts_matches_jax(tmp_path, capsys, monkeypatch):
    """``certify.py --attempts 2 --cell-deadline 600`` through ``main``: each
    cell's search result against the JAX package's on the same draws
    (ratios and deviations at SEARCH_TOL), the verdicts exactly, with no
    retry, quarantine or resume."""
    from test_torch_certify import DrawBook, _assert_search

    monkeypatch.setenv("BLADES_LEDGER", str(tmp_path / "ledger.jsonl"))
    monkeypatch.delenv("BLADES_RESUME", raising=False)
    args = _cert_args()
    DrawBook(monkeypatch, args.seed, args.trials, args.clients, args.dim)
    plans, specs = jax_certify.enumerate_cells(args)
    jax_results, walls, report = jax_certify.execute_cells(args, plans, specs)
    want = jax_certify.assemble_matrix(args, plans, specs, jax_results, walls, report)
    kept = {}
    execute = certify.execute_cells

    def spy(args_, plans_, specs_, **kw):
        out = execute(args_, plans_, specs_, **kw)
        kept.update(labels=[s.label for s in specs_], results=out[0])
        return out

    monkeypatch.setattr(certify, "execute_cells", spy)
    rc = certify.main(["--device", "cpu", "--quick", "--no-async", "--aggs", *args.aggs,
                       "--attempts", "2", "--cell-deadline", "600", "--out", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["ok"], summary
    assert (summary["retried"], summary["quarantined"], summary["resumed"]) == (0, [], False)
    assert kept["labels"] == [s.label for s in specs]
    for label, got, ref in zip(kept["labels"], kept["results"], jax_results):
        _assert_search(got, ref, label)
    got = json.loads((tmp_path / "cert_matrix.json").read_text())
    assert got["quarantined_cells"] == [] and got["ok"] is True and want["ok"] is True
    assert [(r["agg"], r["f"], r["certified"]) for r in got["cells"]] == [
        (r["agg"], r["f"], r["certified"]) for r in want["cells"]]
    for name, entry in want["battery"].items():
        assert {c: r["ok"] for c, r in got["battery"][name]["contracts"].items()} == {
            c: r["ok"] for c, r in entry["contracts"].items()}
    records = _records(tmp_path / "sweep_trace.jsonl")
    assert validate_records(records) == []
    assert not [r for r in records if r["t"] in ("retry", "quarantine", "resume")]


def test_certify_sequential_quarantine_records(tmp_path, monkeypatch):
    """``--sequential`` goes through the per-cell loop: a poison cell is
    retried, then quarantined (a ``quarantine`` record, a flagged sweep
    record, a journal entry) and every other cell lands, as in JAX."""
    real = certify._execute_group

    def poison(group, key, **kw):
        if group[0].label == "median/f1":
            raise ValueError("sequential poison")
        return real(group, key, **kw)

    monkeypatch.setattr(certify, "_execute_group", poison)
    args = _cert_args(clients=4, dim=4, trials=1, aggs=["mean", "median"], sequential=True)
    trace = str(tmp_path / "sweep_trace.jsonl")
    sw = port_timeline.SweepAccounting("certify", total=6, path=trace)
    journal = port_journal.SweepJournal(str(tmp_path / "j.jsonl"), fingerprint="fp")
    m = certify.certify_matrix(args, sweep=sw, journal=journal,
                               resilience=port_resilient.ResilienceOptions(
                                   attempts=2, base_delay_s=0.0, sleep=lambda s: None))
    sw.close()
    journal.close()
    assert m["ok"] is False
    assert [q["cell"] for q in m["quarantined_cells"]] == ["median/f1"]
    assert m["quarantined_cells"][0]["error_type"] == "ValueError"
    assert len(m["cells"]) == 3 and journal.has("median/f1")
    records = _records(trace)
    assert [r["cell"] for r in records if r["t"] == "quarantine"] == ["median/f1"]
    assert [r for r in records if r["t"] == "retry"]
    assert [r["cell"] for r in records if r["t"] == "sweep" and r.get("quarantined")] == [
        "median/f1"]
    assert validate_records(records) == []


def _certify_proc(out, env, **extra):
    argv = [sys.executable, "-m", "blades_tpu_torch.examples.certify", "--device", "cpu",
            "--quick", "--clients", "6", "--dim", "8", "--trials", "2", "--no-async",
            "--aggs", "mean", "median", "krum", "--out", str(out)]
    return subprocess.run(argv, capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env=dict(env, **extra))


def _strip_times(m):
    m = json.loads(json.dumps(m))
    for k in ("wall_s", "resumed", "resumed_skipped", "retried", "degraded_groups"):
        m.pop(k, None)
    for row in m["cells"] + m["async_cells"]:
        row.pop("search_s")
    return m


def test_certify_killed_mid_sweep_resumes_to_the_same_matrix(tmp_path):
    """The certify driver SIGKILLed by the journal's saboteur after its 4th
    cell, relaunched under ``BLADES_RESUME=1``: the relaunch runs only the
    remaining cells and its matrix is the uninterrupted run's, times
    aside."""
    env = {k: v for k, v in os.environ.items() if k not in ("BLADES_RESUME", "PYTHONPATH")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS=str(worker_threads()),
               BLADES_LEDGER=str(tmp_path / "ledger.jsonl"))
    env.pop(port_journal.KILL_AT_ENV, None)
    ref = _certify_proc(tmp_path / "ref", env)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    killed = _certify_proc(tmp_path / "run", env, **{port_journal.KILL_AT_ENV: "4"})
    assert killed.returncode == -signal.SIGKILL, killed.stdout + killed.stderr
    resumed = _certify_proc(tmp_path / "run", env, BLADES_RESUME="1",
                            **{port_journal.KILL_AT_ENV: "4"})
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    summary = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert summary["resumed"] is True and summary["resumed_skipped"] == 4
    a = json.loads((tmp_path / "ref" / "cert_matrix.json").read_text())
    b = json.loads((tmp_path / "run" / "cert_matrix.json").read_text())
    assert _strip_times(a) == _strip_times(b)
    records = _records(tmp_path / "run" / "sweep_trace.jsonl")
    at = max(i for i, r in enumerate(records) if r["t"] == "resume")
    ran = [r for r in records[at:] if r["t"] == "sweep" and r.get("i") and not r.get("resumed")]
    assert len(ran) == records[at]["total"] - records[at]["skipped"]
    assert validate_records(records) == []


# -- the status surface ------------------------------------------------------------


def test_sweep_status_counts_the_ports_trace_as_the_jaxs(tmp_path):
    """``scripts/sweep_status.py``, unchanged, reads the port's resilient
    trace of a resumed, retried and quarantining sweep and counts what it
    counts on the JAX package's trace of the same failures."""
    counts = {}
    for pkg in ("jax", "port"):
        path = str(tmp_path / f"{pkg}_prefix.jsonl")
        j = PKGS[pkg].Journal(path, fingerprint="fp")
        j.record("c0", _ok("c0"))
        j.close()
        (tmp_path / pkg).mkdir()
        out = _grouped_run(pkg, tmp_path / pkg, 6, _two_poisons, {}, journal_path=path,
                           resume=True)
        fam = summarize_sweeps(load_sweep_records(out["trace"]))["sweeps"]["certify"]
        counts[pkg] = {k: fam.get(k) for k in (
            "cells", "total", "done", "frac", "errors", "retried", "quarantined",
            "resumed_skipped", "batched_cells", "batches", "deadline_unenforced")}
    assert counts["port"] == counts["jax"]
    assert counts["port"]["quarantined"] == 2 and counts["port"]["resumed_skipped"] == 1
    assert counts["port"]["done"] == 6
