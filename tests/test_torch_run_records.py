"""The run's own records in the port (``telemetry/ledger.py``,
``telemetry/alerts.py``, ``telemetry/timeline.py``,
``supervision/heartbeat.py`` and their wiring in ``Simulator.run``)
against the JAX package's.

Mirrors ``tests/test_run_identity.py`` (the ledger, the alert rules and the
simulator's ledger records), ``tests/test_timeline.py`` (launch and sweep
accounting) and ``tests/test_supervision.py`` (the heartbeat). The alert
rules run on the same hand-fed record streams in both packages, with the
port's build counters where the JAX stream carries XLA compiles; a K=10 MLP
run in each package writes ledger, ``timeline`` and ``alert`` records with
the same keys.
"""

import json
import math
import os
import time

import pytest
import torch

from blades_tpu.supervision import heartbeat as jax_hb
from blades_tpu.telemetry import alerts as jax_alerts
from blades_tpu.telemetry import ledger as jax_ledger
from blades_tpu_torch import sweeps
from blades_tpu_torch.supervision import heartbeat as hb
from blades_tpu_torch.telemetry import (
    Recorder,
    alerts,
    context,
    ledger,
    set_recorder,
    timeline,
)
from blades_tpu_torch.telemetry import recorder as recorder_mod
from blades_tpu_torch.telemetry.schema import load_trace, validate_records
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture()
def clean_ctx(monkeypatch):
    """No run context in the environment, nothing minted."""
    monkeypatch.delenv(context.RUN_ID_ENV, raising=False)
    monkeypatch.delenv(context.ATTEMPT_ENV, raising=False)
    monkeypatch.setattr(context, "_minted", set())
    return monkeypatch


@pytest.fixture(autouse=True)
def _clean_timeline_state():
    # each test starts with no active recorder: a recorder that an earlier
    # Simulator run in this process left installed is flushed here, not
    # inside the test (where it would count among the test's flushes)
    prev = set_recorder(None)
    timeline.reset()
    yield
    timeline.reset()
    set_recorder(prev)


# -- the ledger ------------------------------------------------------------------


def test_config_fingerprint_is_the_sweeps_copy_and_jaxs():
    assert ledger.config_fingerprint is sweeps.config_fingerprint
    for cfg in ({"x": 1, "y": [2, 3]}, {"y": [2, 3], "x": 1}, {"k": "v", "n": None}):
        assert ledger.config_fingerprint(cfg) == jax_ledger.config_fingerprint(cfg)
    assert ledger.LEDGER_ENV == jax_ledger.LEDGER_ENV
    assert ledger.OUTCOMES == jax_ledger.OUTCOMES
    # the port's default never names the JAX package's committed ledger
    assert ledger.DEFAULT_PATH != jax_ledger.DEFAULT_PATH


def test_ledger_started_finished_pair_like_jax(clean_ctx, tmp_path):
    recs = {}
    for name, mod in (("port", ledger), ("jax", jax_ledger)):
        path = str(tmp_path / f"{name}.jsonl")
        clean_ctx.setenv(mod.LEDGER_ENV, path)
        entry = mod.run_started("simulator", config={"k": 6}, artifacts=["a"])
        entry.ended("finished", metrics={"rounds_completed": 2})
        assert entry.ended("finished") is None  # the first outcome wins
        recs[name] = mod.read_ledger(path)
    got, want = recs["port"], recs["jax"]
    assert [r["event"] for r in got] == ["started", "finished"]
    started, finished = got
    assert started["run_id"] == finished["run_id"] == os.environ[context.RUN_ID_ENV]
    assert started["config"] == {"k": 6} and started["artifacts"] == ["a"]
    assert started["config_fingerprint"] == want[0]["config_fingerprint"]
    assert finished["metrics"] == {"rounds_completed": 2} and finished["wall_s"] >= 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
    assert validate_records(got) == []


def test_ledger_crash_beats_finally_finished(clean_ctx, tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    clean_ctx.setenv(ledger.LEDGER_ENV, path)
    entry = ledger.run_started("simulator")
    entry.ended("crashed", error="boom")
    entry.ended("finished")
    recs = ledger.read_ledger(path)
    assert [r["event"] for r in recs] == ["started", "crashed"]
    assert recs[1]["error"] == "boom"


def test_ledger_disabled_is_inert(clean_ctx):
    clean_ctx.setenv(ledger.LEDGER_ENV, "0")
    entry = ledger.run_started("certify", config={"a": 1})
    assert entry.path is None and entry.ended("finished") is None
    assert ledger.record_event("certify", "killed") is None
    assert ledger.ledger_path() is None


def test_read_ledger_skips_torn_lines(tmp_path):
    path = tmp_path / "ledger.jsonl"
    path.write_text('{"t": "ledger", "event": "started", "run_id": "r", "attempt": 1}\n'
                    '{"t": "ledger", "ev')
    recs = ledger.read_ledger(str(path))
    assert len(recs) == 1 and recs[0]["event"] == "started"


_BASE = {"t": "ledger", "run_id": "r", "attempt": 1, "kind": "simulator"}
PAIR_STREAMS = {
    "killed_then_relaunch": [
        dict(_BASE, event="started", ts=1.0, config_fingerprint="fp"),
        dict(_BASE, event="killed", kind="supervised"),
        dict(_BASE, event="started", attempt=2, ts=2.0, config_fingerprint="fp"),
        dict(_BASE, event="finished", attempt=2, wall_s=3.0, metrics={"rounds_per_sec": 4.0}),
        {"t": "ledger", "event": "started", "run_id": "other", "attempt": 1, "kind": "bench",
         "ts": 3.0},
    ],
    "shared_id_entry_points": [
        dict(_BASE, event="started", kind="tpu_capture", ts=1.0),
        dict(_BASE, event="started", kind="bench", ts=2.0, config_fingerprint="fpb"),
        dict(_BASE, event="finished", kind="bench", metrics={"rounds_per_sec": 9.9}),
        dict(_BASE, event="finished", kind="tpu_capture", metrics={"exit": 0}),
    ],
    "sequential_same_kind": [
        dict(_BASE, event="started", ts=1.0, config_fingerprint="fp1"),
        dict(_BASE, event="crashed", error="boom"),
        dict(_BASE, event="started", ts=2.0, config_fingerprint="fp2"),
        dict(_BASE, event="finished", metrics={"rounds_completed": 3}),
    ],
}


@pytest.mark.parametrize("stream", sorted(PAIR_STREAMS))
def test_pair_runs_matches_jax(stream):
    recs = PAIR_STREAMS[stream]
    assert ledger.pair_runs(recs) == jax_ledger.pair_runs(recs)


def test_code_version_and_env_fingerprint(monkeypatch):
    assert ledger.code_version() == jax_ledger.code_version()
    assert len(ledger.code_version() or "x" * 40) == 40

    def no_init(*a, **k):
        raise AssertionError("the fingerprint initialized CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_name", no_init)
    monkeypatch.setattr(torch.cuda, "init", no_init)
    fp = ledger.env_fingerprint()
    assert fp["torch"] == torch.__version__ and "cuda_runtime" in fp
    assert fp["python"] and "device_kind" not in fp


def test_run_started_omits_code_version_outside_git(clean_ctx, tmp_path, monkeypatch):
    path = str(tmp_path / "ledger.jsonl")
    clean_ctx.setenv(ledger.LEDGER_ENV, path)
    monkeypatch.setattr(ledger, "code_version", lambda: None)
    ledger.run_started("bench").ended("finished")
    recs = ledger.read_ledger(path)
    assert "code_version" not in recs[0] and validate_records(recs) == []


# -- the alert rules, against JAX's on the same streams -------------------------


def _rounds(losses=(), walls=(), compiles=None, margins=None, counter="xla.compiles"):
    recs = []
    for i, loss in enumerate(losses):
        r = {"t": "round", "round": i, "train_loss": loss, "counters": {}, "gauges": {}}
        if walls:
            r["wall_s"] = walls[i]
        if compiles and i in compiles:
            r["counters"][counter] = compiles[i]
        if margins and i < len(margins):
            r["gauges"]["heartbeat.margin_s"] = margins[i]
        recs.append(r)
    return recs


ALERT_STREAMS = {
    "loss_nonfinite": dict(losses=[1.0, float("nan")]),
    "loss_inf": dict(losses=[1.0, 2.0, float("inf")]),
    "loss_divergence": dict(losses=[1.0, 1.0, 1.0, 5.0, 5.0, 5.0, 9.0, 9.0, 9.0]),
    "converging": dict(losses=[1.0, 0.9, 0.8, 0.7, 0.65, 0.6, 0.58, 0.55]),
    "compile_warmup": dict(losses=[1.0] * 4, compiles={0: 5, 1: 2}),
    "compile_late_eval": dict(losses=[1.0] * 6, compiles={0: 5, 4: 2}),
    "compile_storm": dict(losses=[1.0] * 8, compiles={0: 5, 4: 2, 6: 1}),
    "throughput_drop": dict(losses=[1.0] * 9, walls=[0.1] * 8 + [0.9]),
    "throughput_steady": dict(losses=[1.0] * 9, walls=[0.1] * 9),
    "margin_shrinking": dict(losses=[1.0] * 4, margins=[8.0, 6.0, 4.0, 2.0]),
    "margin_steady": dict(losses=[1.0] * 4, margins=[8.0, 7.9, 8.1, 8.0]),
}
OTHER_STREAMS = {
    "norm_collapse": [{"t": "metrics", "round": 1, "norm_hist": [2, 5, 2, 1, 0]},
                      {"t": "metrics", "round": 2, "norm_hist": [0, 1, 0, 0, 9]}],
    "breach_healthy": [{"t": "audit", "round": i, "breach": 0} for i in range(8)],
    "breach_storm": [{"t": "audit", "round": i, "breach": 1 if i >= 4 else 0}
                     for i in range(8)],
    "margin_low": [{"t": "heartbeat_margin", "round": 3, "interval_s": 9.0, "margin_s": 1.0,
                    "timeout_s": 10.0}],
    "malformed": [{"t": "round"}, {"t": "metrics", "norm_hist": "not-a-list"},
                  {"t": "audit", "breach": "nope"},
                  {"t": "round", "round": 5, "train_loss": float("nan")}],
}


def _same_alerts(got, want):
    def key(a):
        return [(r["rule"], r["severity"], r.get("round"), r.get("value"), r.get("threshold"))
                for r in a]

    assert key(got) == key(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)


@pytest.mark.parametrize("stream", sorted(ALERT_STREAMS))
def test_alert_rules_on_round_streams_match_jax(stream):
    kw = ALERT_STREAMS[stream]
    want = jax_alerts.evaluate_records(_rounds(**kw))
    # the port's compile storm counts graph captures and kernel builds
    for counter in alerts.BUILD_COUNTERS:
        got = alerts.evaluate_records(_rounds(**kw, counter=counter))
        _same_alerts(got, want)
    if stream == "compile_storm":
        assert [a["rule"] for a in want] == ["compile_storm"]
        assert "graph capture" in alerts.evaluate_records(
            _rounds(**kw, counter="cuda.graph_captures"))[0]["message"]


@pytest.mark.parametrize("stream", sorted(OTHER_STREAMS))
def test_alert_rules_on_other_streams_match_jax(stream):
    recs = OTHER_STREAMS[stream]
    _same_alerts(alerts.evaluate_records(recs), jax_alerts.evaluate_records(recs))


def test_alert_records_ride_the_recorder_and_validate(clean_ctx, tmp_path):
    path = str(tmp_path / "t.jsonl")
    rec = Recorder(path=path, meta={"run": "x"})
    assert alerts.install(rec) is not None
    rec.round_record(0, train_loss=float("inf"), wall_s=0.1)
    rec.close()
    recs = _records(path)
    alert = [r for r in recs if r["t"] == "alert"]
    assert len(alert) == 1 and alert[0]["rule"] == "loss_nonfinite"
    assert alert[0]["run_id"] == os.environ[context.RUN_ID_ENV]
    assert validate_records(recs) == []


def test_alerts_off_by_env_or_with_telemetry(clean_ctx, tmp_path):
    assert alerts.ALERTS_ENV == jax_alerts.ALERTS_ENV
    assert alerts.ALERT_FILE_ENV == jax_alerts.ALERT_FILE_ENV
    assert alerts.install(Recorder(path=str(tmp_path / "a.jsonl"), enabled=False)) is None
    clean_ctx.setenv(alerts.ALERTS_ENV, "0")
    assert alerts.install(Recorder(path=str(tmp_path / "b.jsonl"))) is None


def test_critical_alert_writes_the_alert_file(clean_ctx, tmp_path):
    hook = tmp_path / "alert"
    clean_ctx.setenv(alerts.ALERT_FILE_ENV, str(hook))
    alerts.evaluate_records(_rounds(losses=[float("nan")]))  # offline: never
    assert not hook.exists()
    rec = Recorder(path=str(tmp_path / "t.jsonl"))
    alerts.install(rec)
    rec.round_record(0, train_loss=float("nan"))
    rec.close()
    body = json.loads(hook.read_text())
    assert body["rule"] == "loss_nonfinite" and body["severity"] == "critical"
    hook.unlink()
    rec2 = Recorder(path=str(tmp_path / "t2.jsonl"))
    alerts.install(rec2)
    for i, w in enumerate([0.1] * 8 + [0.9]):  # a warn alert only
        rec2.round_record(i, train_loss=1.0, wall_s=w)
    rec2.close()
    assert not hook.exists()


def test_a_broken_observer_never_takes_down_the_run(tmp_path):
    rec = Recorder(path=str(tmp_path / "t.jsonl"))

    def boom(record):
        raise RuntimeError("rule bug")

    rec.observer = boom
    rec.event("run_end", rounds_completed=0)
    assert rec.records[-1]["t"] == "run_end"


# -- process counters and the timeline --------------------------------------------


def test_process_counters_feed_observers_and_the_recorder():
    rec = Recorder(enabled=True)
    set_recorder(rec)
    seen = []
    obs = lambda name, inc: seen.append((name, inc))  # noqa: E731
    recorder_mod.add_counter_observer(obs)
    recorder_mod.add_counter_observer(obs)  # once per function
    before = recorder_mod.process_counters()
    try:
        recorder_mod.count_process("cuda.graph_captures")
        recorder_mod.count_process("cuda.graph_capture_s", 0.5)
    finally:
        recorder_mod._counter_observers.remove(obs)
        recorder_mod._PROCESS_COUNTERS.clear()
        recorder_mod._PROCESS_COUNTERS.update(before)
    assert seen == [("cuda.graph_captures", 1), ("cuda.graph_capture_s", 0.5)]
    assert rec.counters == {"cuda.graph_captures": 1, "cuda.graph_capture_s": 0.5}
    assert set(recorder_mod.PROCESS_COUNTER_NAMES) >= set(alerts.BUILD_COUNTERS)


def test_kernel_build_reuse_is_counted(monkeypatch, tmp_path):
    """``ops/_build.py`` counts a library found up to date as a reuse."""
    from blades_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib = tmp_path / f"trimmed_mean-{_build._digest()}.so"
    lib.write_bytes(b"")
    before = recorder_mod.process_counters().get("cuda.kernel_reuses", 0)
    assert _build.build("trimmed_mean").seconds == 0.0
    assert recorder_mod.process_counters()["cuda.kernel_reuses"] == before + 1


def test_launch_split_and_counter_join():
    rec = Recorder(enabled=True)
    set_recorder(rec)
    base = dict(recorder_mod._PROCESS_COUNTERS)
    try:
        timeline.launch_begin("round", rounds=1, attrs={"streaming": 1})
        recorder_mod.count_process("cuda.graph_captures")
        recorder_mod.count_process("cuda.graph_capture_s", 0.25)
        recorder_mod.count_process("cuda.kernel_builds")
        recorder_mod.count_process("cuda.kernel_build_s", 0.25)
        recorder_mod.count_process("cuda.kernel_reuses")
        timeline.launch_enqueued()
        timeline.launch_ready(0.25)
        timeline.emit(rec, round_idx=7)
    finally:
        recorder_mod._PROCESS_COUNTERS.clear()
        recorder_mod._PROCESS_COUNTERS.update(base)
    (r,) = [r for r in rec.records if r["t"] == "timeline"]
    assert r["kind"] == "round" and r["launches"] == 1 and r["rounds"] == 1
    assert r["ready_s"] == pytest.approx(0.25) and r["round"] == 7
    assert r["compiles"] == 2 and r["compile_s"] == pytest.approx(0.5)
    assert r["cache_misses"] == 1 and r["cache_hits"] == 1
    assert r["streaming"] == 1 and 0.0 <= r["dispatch_share"] <= 1.0
    assert validate_records([r]) == []
    timeline.emit(rec)  # the accumulator was drained
    assert len([r for r in rec.records if r["t"] == "timeline"]) == 1


def test_disabled_recorder_makes_the_hooks_free(monkeypatch):
    set_recorder(None)

    def boom(*a, **k):
        raise AssertionError("disabled accounting read the clock")

    monkeypatch.setattr(timeline.time, "perf_counter", boom)
    timeline.launch_begin("round")
    timeline.launch_enqueued()
    timeline.launch_ready()
    timeline.emit()
    assert timeline._acc == {} and timeline._open_launch is None


def test_unsynced_launch_folds_with_zero_ready():
    rec = Recorder(enabled=True)
    set_recorder(rec)
    timeline.launch_begin("round")
    timeline.launch_enqueued()
    timeline.launch_begin("round")
    timeline.launch_enqueued()
    timeline.launch_ready(0.1)
    timeline.emit(rec)
    r = [x for x in rec.records if x["t"] == "timeline"][0]
    assert r["launches"] == 2 and r["ready_s"] == pytest.approx(0.1)


def _port_run(tmp_path, rounds=2, agg="median", **run_kw):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    ds = Synthetic(num_clients=6, train_size=240, test_size=60, noise=0.3, cache=False)
    log = str(tmp_path / "out")
    sim = Simulator(ds, log_path=log, seed=0, aggregator=agg, device="cpu")
    sim.run("mlp", global_rounds=rounds, local_steps=1, train_batch_size=8, client_lr=0.2,
            validate_interval=99, **run_kw)
    trace = os.path.join(log, "telemetry.jsonl")
    return sim, (load_trace(trace) if os.path.exists(trace) else [])


@pytest.mark.parametrize("mode,run_kw,kind", [
    ("dense", {}, "round"),
    ("streaming", {"streaming": True, "client_chunks": 3}, "round"),
    ("block", {"block_size": 2}, "block"),
    ("async", {"async_config": {"buffer_m": 3,
                                "arrivals": {"kind": "uniform", "max_delay": 2}}}, "round"),
])
def test_timeline_records_every_round_semantics(tmp_path, monkeypatch, mode, run_kw, kind):
    monkeypatch.setenv(ledger.LEDGER_ENV, str(tmp_path / "ledger.jsonl"))
    _, records = _port_run(tmp_path, rounds=4 if kind == "block" else 2, **run_kw)
    tls = [r for r in records if r["t"] == "timeline"]
    assert tls and {r["kind"] for r in tls} == {kind}
    assert validate_records(records) == []
    for r in tls:
        assert r["enqueue_s"] > 0.0 and r["ready_s"] >= 0.0
        assert r["streaming"] == int(mode == "streaming")
        assert r["async"] == int(mode == "async")
    rounds = [r for r in records if r["t"] == "round"]
    if kind == "block":
        assert [r["round"] for r in tls] == [2, 4] and all(r["rounds"] == 2 for r in tls)
    else:
        assert [r["round"] for r in tls] == [r["round"] for r in rounds]
    # enqueue is the dispatch span's own time; the window fits in the round
    disp = sum(r["dur_s"] for r in records
               if r["t"] == "span" and r["path"] == f"{kind}/dispatch")
    enq = sum(r["enqueue_s"] for r in tls)
    assert enq == pytest.approx(disp, rel=0.05, abs=0.05)
    outer = sum(r["dur_s"] for r in records if r["t"] == "span" and r["path"] == kind)
    assert enq + sum(r["ready_s"] for r in tls) <= outer + 0.05


def test_flush_discipline_unchanged_with_the_records(tmp_path, monkeypatch):
    monkeypatch.setenv(ledger.LEDGER_ENV, str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv(hb.HEARTBEAT_ENV, str(tmp_path / "hb"))
    flushes = []
    real_flush = Recorder.flush

    def counting_flush(self):
        if self.path is not None:
            flushes.append(len(self._pending))
        return real_flush(self)

    monkeypatch.setattr(Recorder, "flush", counting_flush)
    sim, recs = _port_run(tmp_path, rounds=4, streaming=True, client_chunks=3, block_size=2)
    assert sim.telemetry.dropped == 0
    # the meta record, 2 block boundaries, run_end
    assert len(flushes) <= 4
    assert len([r for r in recs if r["t"] == "timeline"]) == 2
    assert hb.read(str(tmp_path / "hb"))["round"] == 4


def test_telemetry_off_writes_no_records(tmp_path, monkeypatch):
    monkeypatch.setenv("BLADES_TELEMETRY", "0")
    monkeypatch.setenv(ledger.LEDGER_ENV, str(tmp_path / "ledger.jsonl"))
    sim, recs = _port_run(tmp_path, rounds=2)
    assert recs == [] and sim.alert_engine is None
    assert timeline._acc == {} and timeline._open_launch is None
    # the ledger is its own switch
    assert [r["event"] for r in ledger.read_ledger(str(tmp_path / "ledger.jsonl"))] == [
        "started", "finished"]


# -- sweep accounting ---------------------------------------------------------------


def test_sweep_accounting_records_progress_flushes_and_beats(tmp_path, monkeypatch):
    hb_file = str(tmp_path / "hb")
    monkeypatch.setenv(hb.HEARTBEAT_ENV, hb_file)
    monkeypatch.setattr(hb, "_last_beat_ts", None)
    trace = str(tmp_path / "sweep_trace.jsonl")
    sw = timeline.SweepAccounting("unit", total=3, path=trace)
    sizes = []
    for i in range(3):
        with sw.cell(f"cell{i}"):
            pass
        sizes.append(os.path.getsize(trace))
        assert hb.read(hb_file)["round"] == i + 1
    assert sizes[0] < sizes[1] < sizes[2]
    sw.close()
    records = _records(trace)
    cells = [r for r in records if r["t"] == "sweep"]
    assert [c["i"] for c in cells] == [1, 2, 3] and cells[-1]["eta_s"] == 0.0
    assert all(c["wall_s"] >= c["execute_s"] >= 0.0 for c in cells)
    assert validate_records(records) == [] and sw.summary()["cells"] == 3


def test_sweep_cell_error_is_recorded_and_reraised(tmp_path):
    trace = str(tmp_path / "t.jsonl")
    sw = timeline.SweepAccounting("unit", total=1, path=trace)
    with pytest.raises(RuntimeError, match="boom"):
        with sw.cell("bad"):
            raise RuntimeError("boom")
    sw.close()
    cells = [r for r in _records(trace) if r["t"] == "sweep"]
    assert cells[0]["ok"] is False and "boom" in cells[0]["error"]
    assert validate_records(cells) == []


def test_grouped_search_records_stamp_the_batch(tmp_path):
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.audit import QUICK_GRIDS, battery_ctx, synthetic_honest

    tr = synthetic_honest(torch.Generator().manual_seed(0), 1, 6, 8)
    ctx = battery_ctx(None, 6, 8)
    cells = [sweeps.SweepCell(f"m/f{f}", get_aggregator("median"), tr, f, ctx) for f in (1, 2)]
    rec = Recorder(path=str(tmp_path / "t.jsonl"))
    set_recorder(rec)
    sw = timeline.SweepAccounting("certify", total=2, path=str(tmp_path / "sweep.jsonl"))
    sweeps.run_grouped(cells, grids=QUICK_GRIDS, sweep=sw)
    sw.close()
    inner = [r for r in rec.records if r["t"] == "sweep"]
    outer = [r for r in _records(str(tmp_path / "sweep.jsonl")) if r["t"] == "sweep"]
    for group in (inner, outer):
        assert [r["cell"] for r in group] == ["m/f1", "m/f2"]
        assert len({r["batch"] for r in group}) == 1 and all(r["batch_size"] == 2
                                                            for r in group)
        assert validate_records(group) == []


# -- the heartbeat ---------------------------------------------------------------


def test_heartbeat_constants_match_jax():
    for name in ("HEARTBEAT_ENV", "SUPERVISED_ENV", "RESUME_ENV", "TIMEOUT_ENV",
                 "MARGIN_WARN_FRAC"):
        assert getattr(hb, name) == getattr(jax_hb, name), name
    from blades_tpu_torch.utils.checkpoint import RESUME_ENV

    assert RESUME_ENV is hb.RESUME_ENV


def test_beat_noop_without_env_and_age(tmp_path, monkeypatch):
    monkeypatch.delenv(hb.HEARTBEAT_ENV, raising=False)
    hb.beat(round_idx=1)
    f = tmp_path / "hb"
    hb.beat(round_idx=3, path=str(f))
    rec = hb.read(str(f))
    assert rec["t"] == "heartbeat" and rec["round"] == 3
    assert hb.age_s(str(f)) < 5.0 and hb.age_s(str(tmp_path / "missing")) is None
    assert hb.age_s(str(f), now=os.stat(f).st_mtime + 7.0) == pytest.approx(7.0)


def test_beat_env_path_and_bad_path(tmp_path, monkeypatch):
    f = tmp_path / "hb"
    monkeypatch.setenv(hb.HEARTBEAT_ENV, str(f))
    hb.beat(round_idx=7)
    assert hb.read(str(f))["round"] == 7
    monkeypatch.setenv(hb.HEARTBEAT_ENV, "/proc/definitely/not/writable/hb")
    hb.beat(round_idx=1)  # swallowed


def test_beat_body_and_margin_record_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(hb.TIMEOUT_ENV, "0.001")
    bodies = {}
    for name, mod in (("port", hb), ("jax", jax_hb)):
        monkeypatch.setattr(mod, "_last_beat_ts", None)
        f = str(tmp_path / name)
        mod.beat(round_idx=1, path=f)
        time.sleep(0.01)  # past 0.75 of the 1 ms timeout
        rec = Recorder(enabled=True)
        set_recorder(rec)
        mod.beat(round_idx=2, path=f)
        bodies[name] = mod.read(f)
        if name == "port":
            margin = [r for r in rec.records if r["t"] == "heartbeat_margin"]
            assert len(margin) == 1 and margin[0]["round"] == 2
            assert "heartbeat.margin_s" in rec.gauges and validate_records(margin) == []
    assert sorted(bodies["port"]) == sorted(bodies["jax"])
    assert bodies["port"]["round"] == 2 and bodies["port"]["interval_s"] >= 0


# -- Simulator.run: the ledger, alerts and the heartbeat -------------------------


@pytest.fixture(scope="module")
def healthy_run(tmp_path_factory):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    tmp = tmp_path_factory.mktemp("run_records")
    led, hb_file = str(tmp / "ledger.jsonl"), str(tmp / "hb")
    mp = pytest.MonkeyPatch()
    mp.setenv(ledger.LEDGER_ENV, led)
    mp.setenv(hb.HEARTBEAT_ENV, hb_file)
    try:
        ds = Synthetic(num_clients=6, train_size=240, test_size=60, cache=False)
        log = str(tmp / "out")
        sim = Simulator(ds, log_path=log, seed=0, aggregator="mean", device="cpu")
        sim.run("mlp", global_rounds=3, local_steps=1, train_batch_size=8,
                validate_interval=3, round_metrics=True)
    finally:
        mp.undo()
    return {"ledger": ledger.read_ledger(led), "trace": load_trace(os.path.join(
        log, "telemetry.jsonl")), "heartbeat": hb.read(hb_file), "sim": sim}


def test_simulator_run_writes_the_ledger_pair(healthy_run):
    recs = healthy_run["ledger"]
    assert [r["event"] for r in recs] == ["started", "finished"]
    started, finished = recs
    assert started["kind"] == "simulator" and started["run_id"] == finished["run_id"]
    assert started["config"]["num_clients"] == 6 and started["config_fingerprint"]
    assert started["env"]["torch"] == torch.__version__
    assert started["code_version"] == ledger.code_version()
    assert any("telemetry.jsonl" in a for a in started["artifacts"])
    assert finished["metrics"]["rounds_completed"] == 3
    assert finished["metrics"]["rounds_per_sec"] > 0
    assert validate_records(recs) == []


def test_simulator_trace_envelope_timeline_and_no_alerts(healthy_run):
    trace, rid = healthy_run["trace"], healthy_run["ledger"][0]["run_id"]
    assert trace[0]["t"] == "meta" and trace[0]["config_fingerprint"] == (
        healthy_run["ledger"][0]["config_fingerprint"])
    assert all(r.get("run_id") == rid and r.get("attempt") == 1 for r in trace)
    assert [r["round"] for r in trace if r["t"] == "timeline"] == [1, 2, 3]
    assert [r for r in trace if r["t"] == "alert"] == []
    assert alerts.evaluate_records(trace) == []
    assert validate_records(trace) == []
    assert healthy_run["sim"].alert_engine is not None


def test_simulator_beats_the_heartbeat_each_round(healthy_run):
    body = healthy_run["heartbeat"]
    assert body["t"] == "heartbeat" and body["round"] == 3
    assert body["run_id"] == healthy_run["ledger"][0]["run_id"]
    assert validate_records([body]) == []


@pytest.mark.parametrize("exc,outcome", [(RuntimeError, "crashed"),
                                         (KeyboardInterrupt, "killed")])
def test_a_failed_run_ledgers_its_outcome(tmp_path, monkeypatch, exc, outcome):
    led = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv(ledger.LEDGER_ENV, led)

    def fail(rnd, state, m):
        if rnd == 2:
            raise exc("stop")

    with pytest.raises(exc):
        _port_run(tmp_path, rounds=3, on_round_end=fail)
    recs = ledger.read_ledger(led)
    assert [r["event"] for r in recs] == ["started", outcome]
    assert exc.__name__ in recs[1]["error"]
    assert recs[1]["metrics"] == {"rounds_completed": 1}


def test_a_build_crash_still_ledgers_crashed(tmp_path, monkeypatch):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    led = str(tmp_path / "ledger.jsonl")
    monkeypatch.setenv(ledger.LEDGER_ENV, led)
    sim = Simulator(Synthetic(num_clients=4, train_size=80, test_size=20, cache=False),
                    log_path=str(tmp_path / "out"), device="cpu")
    with pytest.raises(Exception):
        sim.run("no_such_model", global_rounds=1)
    recs = ledger.read_ledger(led)
    assert [r["event"] for r in recs] == ["started", "crashed"]
    assert recs[1]["metrics"] == {"rounds_completed": 0}


def test_a_supervised_run_keeps_its_trace(tmp_path, monkeypatch):
    monkeypatch.setenv(ledger.LEDGER_ENV, str(tmp_path / "ledger.jsonl"))
    trace = tmp_path / "out" / "telemetry.jsonl"
    trace.parent.mkdir()
    trace.write_text('{"t": "supervisor", "event": "launch"}\n')
    monkeypatch.setenv(hb.SUPERVISED_ENV, "1")
    _port_run(tmp_path, rounds=1)
    assert json.loads(trace.read_text().splitlines()[0])["t"] == "supervisor"
    monkeypatch.delenv(hb.SUPERVISED_ENV)
    _port_run(tmp_path, rounds=1)  # an unsupervised fresh run starts anew
    assert json.loads(trace.read_text().splitlines()[0])["t"] == "meta"


# -- the same K=10 MLP run in both packages ----------------------------------------


def _both_runs(tmp_path, monkeypatch, client_lr):
    """One K=10 MLP run (3 rounds, mean) in each package, with its ledger
    and trace; ``client_lr`` large enough overflows the weights."""
    from blades_tpu import Simulator as JaxSimulator
    from blades_tpu.datasets import Synthetic as JaxSynthetic
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    out = {}
    for name, sim_cls, ds_cls, kw in (("port", Simulator, Synthetic, {"device": "cpu"}),
                                      ("jax", JaxSimulator, JaxSynthetic, {})):
        led = str(tmp_path / f"{name}_ledger.jsonl")
        hook = str(tmp_path / f"{name}_alert")
        monkeypatch.setenv(ledger.LEDGER_ENV, led)
        monkeypatch.setenv(alerts.ALERT_FILE_ENV, hook)
        ds = ds_cls(num_clients=10, train_size=200, test_size=40, cache=False)
        log = str(tmp_path / name)
        sim = sim_cls(ds, aggregator="mean", log_path=log, seed=0, **kw)
        sim.run("mlp", global_rounds=3, train_batch_size=8, client_lr=client_lr,
                validate_interval=99)
        out[name] = {"ledger": ledger.read_ledger(led),
                     "trace": load_trace(os.path.join(log, "telemetry.jsonl")),
                     "alert_file": hook}
    return out


def _by_type(trace, t):
    return [r for r in trace if r["t"] == t]


def test_same_run_in_both_packages_writes_the_same_record_keys(tmp_path, monkeypatch):
    runs = _both_runs(tmp_path, monkeypatch, client_lr=0.1)
    port, jax_run = runs["port"], runs["jax"]
    assert [r["event"] for r in port["ledger"]] == [r["event"] for r in jax_run["ledger"]]
    for a, b in zip(port["ledger"], jax_run["ledger"]):
        assert sorted(a) == sorted(b)
        if a["event"] == "started":
            assert sorted(a["config"]) == sorted(b["config"])
        else:
            assert sorted(a["metrics"]) == sorted(b["metrics"])
    tl, jtl = _by_type(port["trace"], "timeline"), _by_type(jax_run["trace"], "timeline")
    assert [r["round"] for r in tl] == [r["round"] for r in jtl] == [1, 2, 3]
    times = {"compiles", "compile_s", "trace_s", "cache_hits", "cache_misses"}
    for a, b in zip(tl, jtl):
        # the JAX record carries its first round's XLA compiles
        assert sorted(set(a) - times) == sorted(set(b) - times)
        assert (a["kind"], a["launches"], a["rounds"]) == (b["kind"], b["launches"],
                                                           b["rounds"])
    assert _by_type(port["trace"], "alert") == _by_type(jax_run["trace"], "alert") == []


def test_nonfinite_loss_alerts_in_both_packages(tmp_path, monkeypatch):
    runs = _both_runs(tmp_path, monkeypatch, client_lr=1e20)
    got = {}
    for name, run in runs.items():
        losses = [r["train_loss"] for r in _by_type(run["trace"], "round")]
        assert not all(math.isfinite(x) for x in losses), (name, losses)
        (alert,) = _by_type(run["trace"], "alert")
        assert alert["rule"] == "loss_nonfinite" and alert["severity"] == "critical"
        got[name] = alert
        body = json.loads(open(run["alert_file"]).read())
        assert body["rule"] == "loss_nonfinite"
    assert sorted(got["port"]) == sorted(got["jax"])
    assert got["port"]["round"] == got["jax"]["round"]
    assert validate_records(runs["port"]["trace"]) == []
