"""The port's telemetry (``blades_tpu_torch/telemetry/``) and the trace a
``Simulator.run`` writes, against the JAX package.

The recorder's spans, counters, gauges and events, and its no-op when
telemetry is off; the port's copy of the schema against
``docs/telemetry_schema.json``; then K=10 MLP runs with
``collect_diagnostics``, ``round_metrics`` and an ``AuditMonitor``, eagerly
and in blocks of 2, under a fault model and as async ticks. Each run's
trace validates against the schema, and its ``defense``, ``audit``,
``metrics``, ``faults`` and ``async`` records have the keys and values the
JAX package writes for the same round inputs: every round's matrix, mask
and counters are taken from the port's run as it aggregates them and
handed to the JAX package's fault model, defense, audit monitor and metric
pack, whose results its ``Simulator._log_*`` methods turn into records.
Integers exactly, floats at f32 ``rtol = atol = 1e-5``. The fault model is
deterministic (a participation schedule and a fixed corrupt client), so
both packages see the same faults without injected draws.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu import Simulator as JaxSimulator
from blades_tpu.aggregators import get_aggregator as jax_get_aggregator
from blades_tpu.audit import AuditMonitor as JaxAuditMonitor
from blades_tpu.faults import FaultModel as JaxFaultModel
from blades_tpu.telemetry import Recorder as JaxRecorder
from blades_tpu.telemetry import metric_pack as jax_mp
from blades_tpu.telemetry import schema as jax_schema
from blades_tpu_torch import Simulator
from blades_tpu_torch.audit import AuditMonitor
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.telemetry import NULL_RECORDER, Recorder, get_recorder, set_recorder
from blades_tpu_torch.telemetry import context, profiling, schema
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, F, B = 10, 2, 2
ENVELOPE = ("run_id", "attempt")


# -- the recorder ----------------------------------------------------------------


def test_spans_nest_and_round_records_carry_counter_deltas(tmp_path):
    path = str(tmp_path / "t.jsonl")
    rec = Recorder(path=path, enabled=True, meta={"run": "test"})
    with rec.span("round", round=1):
        with rec.span("sample"):
            pass
        rec.counter("x", 2)
        rec.gauge("g", 0.5)
    rec.round_record(1, wall_s=0.1)
    rec.counter("x", 3)
    rec.counter("y")
    rec.round_record(2)
    rec.event("run_end", rounds_completed=2)
    rec.flush()
    recs = [json.loads(line) for line in open(path)]
    assert [r["t"] for r in recs] == ["meta", "span", "span", "round", "round", "run_end"]
    assert recs[0]["run"] == "test" and recs[0]["pid"] == os.getpid()
    assert recs[1]["path"] == "round/sample" and recs[2]["path"] == "round"
    assert recs[2]["round"] == 1 and recs[2]["dur_s"] >= recs[1]["dur_s"] >= 0
    assert recs[3]["counters"] == {"x": 2} and recs[3]["gauges"] == {"g": 0.5}
    assert recs[4]["counters"] == {"x": 3, "y": 1}
    assert rec.snapshot()["counters"] == {"x": 5, "y": 1}
    ctx = context.current()
    assert all(r["run_id"] == ctx.run_id and r["attempt"] == ctx.attempt for r in recs)
    assert schema.validate_records(recs) == []
    rec.close()


def test_disabled_recorder_is_a_no_op(tmp_path, monkeypatch):
    """Off: no clock read, no file, no record (the clock and the sink
    raise if touched)."""
    import time

    monkeypatch.setenv("BLADES_TELEMETRY", "0")
    rec = Recorder(path=str(tmp_path / "off.jsonl"))
    assert not rec.enabled and rec.path is None

    def boom(*a, **k):
        raise AssertionError("disabled telemetry touched the clock or the sink")

    monkeypatch.setattr(time, "perf_counter", boom)
    monkeypatch.setattr("builtins.open", boom)
    with rec.span("round"):
        rec.counter("x")
        rec.gauge("g", 1)
        rec.event("defense", round=1, agg="a")
        rec.round_record(1)
    rec.flush()
    assert rec.records == [] and rec.counters == {} and not os.listdir(tmp_path)


def test_buffer_is_bounded_and_bad_sinks_do_not_raise(tmp_path):
    rec = Recorder(path=None, enabled=True, max_buffer=10)
    for i in range(25):
        rec.event("faults", round=i)
    assert len(rec.records) <= 10 and rec.dropped > 0
    bad = Recorder(path=str(tmp_path / "x.jsonl"), enabled=True)
    bad.event("defense", round=1, agg="a", obj=object())
    bad.flush()  # a record that does not serialize is counted, not raised
    assert bad.dropped == 0 or bad.dropped >= 1


def test_set_recorder_swaps_and_closes(tmp_path):
    a = Recorder(path=str(tmp_path / "a.jsonl"), enabled=True)
    prev = set_recorder(a)
    try:
        assert get_recorder() is a
        a.event("run_end", rounds_completed=0)
        set_recorder(None)
        assert get_recorder() is NULL_RECORDER
        assert [json.loads(x)["t"] for x in open(tmp_path / "a.jsonl")] == ["meta", "run_end"]
    finally:
        set_recorder(prev if prev is not NULL_RECORDER else None)


def test_context_mints_once_per_fresh_run(monkeypatch):
    monkeypatch.delenv(context.RUN_ID_ENV, raising=False)
    a = context.activate(fresh=True)
    assert context.activate().run_id == a.run_id  # not fresh: kept
    b = context.activate(fresh=True)
    assert b.run_id != a.run_id  # this process minted a: a new run
    monkeypatch.setenv(context.RUN_ID_ENV, "inherited-1")
    monkeypatch.setenv(context.ATTEMPT_ENV, "3")
    c = context.activate(fresh=True)
    assert (c.run_id, c.attempt, c.inherited) == ("inherited-1", 3, True)
    assert context.envelope() == {"run_id": "inherited-1", "attempt": 3}


# -- the schema -----------------------------------------------------------------


def test_schema_copy_equals_the_jax_schema():
    with open(os.path.join(ROOT, "docs", "telemetry_schema.json"), "rb") as f:
        original = f.read()
    with open(schema.SCHEMA_PATH, "rb") as f:
        copy = f.read()
    assert copy == original
    assert schema.load_schema() == jax_schema.load_schema()


RECORDS = [
    {"t": "meta", "ts": 1.0, "pid": 1},
    {"t": "round", "round": 1, "counters": {}, "gauges": {}, "wall_s": 0.1},
    {"t": "round", "round": 1, "counters": {}, "gauges": {}, "extra": 1},
    {"t": "faults", "round": 1, "participants": 1, "dropped": 0, "stale_replayed": 0,
     "stragglers_expired": 0, "corrupted": 0},
    {"t": "nope"},
    {"t": "profile", "action": "start", "dir": "d", "ok": "yes"},
    {"t": "span", "path": "round", "dur_s": 0.1, "run_id": 3},
    {"no_t": 1},
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_record_validation_matches_jax(i):
    s = schema.load_schema()
    got = schema.validate_record(RECORDS[i], s)
    want = jax_schema.validate_record(RECORDS[i], s)
    assert bool(got) == bool(want) and len(got) == len(want)


def test_validate_trace_refuses_an_empty_trace(tmp_path):
    p = tmp_path / "empty.jsonl"
    p.write_text("\n")
    assert schema.validate_trace(str(p))
    assert schema.main([str(p)]) == 1


# -- Simulator runs against the JAX package's records -----------------------------

SCHEDULE = np.ones((2, K), bool)
SCHEDULE[0, [3, 7]] = False
SCHEDULE[1, [5]] = False
FAULTS = dict(participation_schedule=SCHEDULE, corrupt_clients=(4,), corrupt_mode="nan")
ASYNC = dict(buffer_m=6, arrivals=dict(kind="fixed", delays=(0, 1, 2, 0, 1, 2, 0, 1, 2, 0)),
             staleness="polynomial")


def _trace(log_path):
    path = os.path.join(log_path, "telemetry.jsonl")
    assert schema.validate_trace(path) == []
    return [json.loads(line) for line in open(path)]


def _spy(sim, captured):
    """Record, per round, the matrix and mask the defense aggregates and the
    fault model's input, as the port's run hands them over."""
    agg = sim.aggregator
    dense, masked = agg.aggregate_with_diagnostics, agg.aggregate_masked_with_diagnostics

    def spy_dense(updates, state=(), **ctx):
        captured.setdefault("agg", []).append((updates.clone(), None))
        return dense(updates, state, **ctx)

    def spy_masked(updates, state=(), *, mask=None, **ctx):
        captured.setdefault("agg", []).append(
            (updates.clone(), None if mask is None else mask.clone()))
        return masked(updates, state, mask=mask, **ctx)

    agg.aggregate_with_diagnostics = spy_dense
    agg.aggregate_masked_with_diagnostics = spy_masked


def _run_port(tmp_path, name, fault_model=None, async_config=None, block_size=1, rounds=3):
    sim = Simulator(Synthetic(num_clients=K, train_size=300, test_size=40, cache=False),
                    attack="alie", num_byzantine=F, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": B}, seed=1, device="cpu",
                    log_path=str(tmp_path / name))
    captured = {}
    _spy(sim, captured)
    fm = None
    if fault_model is not None:
        from blades_tpu_torch.faults import FaultModel

        fm = FaultModel(**fault_model)
        apply = fm.apply

        def spy_apply(updates, state, generator, round_t):
            captured.setdefault("sent", []).append(updates.clone())
            return apply(updates, state, generator, round_t)

        object.__setattr__(fm, "apply", spy_apply)
    sim.run(model="mlp", global_rounds=rounds, train_batch_size=8, client_chunks=3,
            collect_diagnostics=True, round_metrics=True,
            audit_monitor=AuditMonitor(fallback_aggregator="trimmedmean"),
            fault_model=fm, async_config=async_config, block_size=block_size)
    return sim, captured, _trace(str(tmp_path / name))


def _jax_logger():
    """A JAX Simulator's ``_log_*`` methods on a stub with a memory-only
    JAX recorder."""
    rec = JaxRecorder(path=None, enabled=True)
    stub = types.SimpleNamespace(
        telemetry=rec, aggregator=jax_get_aggregator("trimmedmean", num_byzantine=B),
        engine=types.SimpleNamespace(byz_mask=jnp.arange(K) < F))
    return stub, rec


def _jax_records(sim, captured, trace):
    """The JAX package's records of every round, from the port run's round
    inputs (module docstring)."""
    stub, rec = _jax_logger()
    byz = jnp.arange(K) < F
    jagg = jax_get_aggregator("trimmedmean", num_byzantine=B)
    jmon = JaxAuditMonitor(fallback_aggregator="trimmedmean")
    eng = sim.engine
    jfm = jstate = None
    if eng.fault_model is not None:
        jfm = JaxFaultModel(**FAULTS)
        jstate = jfm.init_state(K, eng.dim)
    asyncs = [r for r in trace if r["t"] == "async"]
    for i, (u, mask) in enumerate(captured["agg"]):
        rnd = i + 1
        ju = jnp.asarray(u.numpy())
        jm = None if mask is None else jnp.asarray(mask.numpy())
        if jfm is not None:
            sent = jnp.asarray(captured["sent"][i].numpy())
            recv, jm2, jstate, fdiag = jfm.apply(sent, jstate, jax.random.PRNGKey(0), i)
            np.testing.assert_array_equal(np.isnan(np.asarray(recv)), np.isnan(u.numpy()))
            np.testing.assert_array_equal(np.asarray(jm2), mask.numpy())
            JaxSimulator._log_faults(stub, rnd, diag=fdiag)
        if jm is None:
            agg, _, ddiag = jagg.aggregate_with_diagnostics(ju, ())
        else:
            agg, _, ddiag = jagg.aggregate_masked_with_diagnostics(ju, (), mask=jm)
            agg = jnp.where(jnp.sum(jm.astype(jnp.int32)) > 0, agg, jnp.zeros_like(agg))
        final, adiag = jmon.apply(ju, agg, mask=jm, byz_mask=byz)
        if asyncs:
            fired = asyncs[i]["fired"]
            final = final * fired
            adiag = dict(adiag, breach=adiag["breach"] * fired,
                         fallback_used=adiag["fallback_used"] * fired,
                         agg_norm=jnp.linalg.norm(final))
            JaxSimulator._log_async(stub, rnd, diag={
                n: jnp.asarray(v) for n, v in asyncs[i].items()
                if n not in ("t", "round") + ENVELOPE})
        pack = jax_mp.pack_dense(ju, jnp.ones(K, bool) if jm is None else jm, byz, final,
                                 eng.client_chunks, eng.chunk_size)
        JaxSimulator._log_defense(stub, rnd, diag=ddiag)
        JaxSimulator._log_audit(stub, rnd, diag=adiag)
        JaxSimulator._log_metrics(stub, rnd, pack=pack)
    return rec.records


def _assert_value(got, want, where):
    if isinstance(want, bool) or isinstance(want, int):
        assert got == want and type(got) is type(want), where
    elif isinstance(want, float):
        assert isinstance(got, float), where
        np.testing.assert_allclose(got, want, err_msg=where, **TOL)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for j, (g, w) in enumerate(zip(got, want)):
            _assert_value(g, w, f"{where}[{j}]")
    else:
        assert got == want, where


def _assert_records_match(trace, jax_records, kinds):
    for kind in kinds:
        ours = [r for r in trace if r["t"] == kind]
        theirs = [r for r in jax_records if r["t"] == kind]
        assert len(ours) == len(theirs) > 0, kind
        for a, b in zip(ours, theirs):
            a = {n: v for n, v in a.items() if n not in ENVELOPE}
            b = {n: v for n, v in b.items() if n not in ENVELOPE}
            assert sorted(a) == sorted(b), (kind, sorted(set(a) ^ set(b)))
            for n in b:
                _assert_value(a[n], b[n], f"{kind} round {b['round']} {n}")


def _assert_run_shape(trace, rounds, kinds, block):
    types_ = [r["t"] for r in trace]
    assert types_[0] == "meta" and types_[-1] == "run_end"
    assert trace[-1]["rounds_completed"] == rounds
    for kind in ("round",) + tuple(kinds):
        assert [r["round"] for r in trace if r["t"] == kind] == list(range(1, rounds + 1)), kind
    paths = {r["path"] for r in trace if r["t"] == "span"}
    top = "block" if block else "round"
    assert {top, f"{top}/dispatch", f"{top}/sync", f"{top}/eval"} <= paths
    if not block:
        assert "round/sample" in paths
    meta = trace[0]
    assert meta["run"] == "simulator" and meta["num_clients"] == K
    assert meta["audit_monitor"].startswith("AuditMonitor(")
    assert len(meta["config_fingerprint"]) == 12
    gauges = [r for r in trace if r["t"] == "round"][-1]["gauges"]
    assert {"engine.peak_update_bytes", "metrics.cos_honest", "audit.breach",
            "defense.byz_trim_frac"} <= set(gauges)


@pytest.mark.parametrize("block_size", [1, 2], ids=["eager", "block2"])
def test_fault_run_records_match_jax(tmp_path, block_size):
    sim, captured, trace = _run_port(tmp_path, f"faults{block_size}", fault_model=FAULTS,
                                     block_size=block_size)
    kinds = ("defense", "audit", "metrics", "faults")
    _assert_run_shape(trace, 3, kinds, block=block_size > 1)
    _assert_records_match(trace, _jax_records(sim, captured, trace), kinds)
    for r in (r for r in trace if r["t"] == "defense"):
        assert sum(r["trim_counts"]) == 2 * B * sim.engine.dim
        assert 0.0 <= r["byz_trim_frac"] <= 1.0
    # the corrupt client never participates, and the schedule's drops show
    faults = [r for r in trace if r["t"] == "faults"]
    assert [r["participants"] for r in faults] == [7, 8, 7]
    assert all(r["corrupted"] == 1 for r in faults)


def test_block_records_equal_the_eager_records(tmp_path):
    """A block's records are its rounds' records, value for value."""
    _, _, eager = _run_port(tmp_path, "eager", fault_model=FAULTS)
    _, _, block = _run_port(tmp_path, "block", fault_model=FAULTS, block_size=2)
    for kind in ("defense", "audit", "metrics", "faults"):
        a = [{n: v for n, v in r.items() if n not in ENVELOPE} for r in eager if r["t"] == kind]
        b = [{n: v for n, v in r.items() if n not in ENVELOPE} for r in block if r["t"] == kind]
        assert a == b, kind


def test_async_run_records_match_jax(tmp_path):
    sim, captured, trace = _run_port(tmp_path, "async", async_config=ASYNC, rounds=4)
    kinds = ("defense", "audit", "metrics", "async")
    _assert_run_shape(trace, 4, kinds, block=False)
    _assert_records_match(trace, _jax_records(sim, captured, trace), kinds)
    fired = [r["fired"] for r in trace if r["t"] == "async"]
    assert 0 < sum(fired) < 4  # ticks that fire and ticks that wait
    for r, f in zip((r for r in trace if r["t"] == "audit"), fired):
        assert r["breach"] <= f and r["fallback_used"] <= f


def test_fresh_run_starts_the_trace_and_resume_appends(tmp_path):
    kw = dict(attack="alie", num_byzantine=F, aggregator="trimmedmean",
              aggregator_kws={"num_byzantine": B}, device="cpu", log_path=str(tmp_path / "r"))
    ds = Synthetic(num_clients=K, train_size=200, test_size=40, cache=False)

    def boom(rnd, state, m):
        if rnd == 2:
            raise RuntimeError("kill")

    with pytest.raises(RuntimeError):
        Simulator(ds, **kw).run(model="mlp", global_rounds=3, train_batch_size=4,
                                on_round_end=boom)
    first = _trace(str(tmp_path / "r"))
    assert [r["t"] for r in first][-2:] == ["crash_checkpoint", "run_end"]
    # round 2 ran (its state is the autosave's) but died before its record
    assert first[-2]["round"] == 2 and first[-1]["rounds_completed"] == 1
    Simulator(ds, **kw).run(model="mlp", global_rounds=3, train_batch_size=4, resume=True)
    resumed = _trace(str(tmp_path / "r"))
    assert resumed[:len(first)] == first
    assert [r["round"] for r in resumed if r["t"] == "round"] == [1, 3]
    Simulator(ds, **kw).run(model="mlp", global_rounds=1, train_batch_size=4)
    fresh = _trace(str(tmp_path / "r"))
    assert [r["round"] for r in fresh if r["t"] == "round"] == [1]


def test_env_switches_turn_on_diagnostics_and_metrics(tmp_path, monkeypatch):
    monkeypatch.setenv("BLADES_TELEMETRY_DIAG", "1")
    monkeypatch.setenv("BLADES_ROUND_METRICS", "1")
    sim = Simulator(Synthetic(num_clients=6, train_size=120, test_size=30, cache=False),
                    aggregator="krum", aggregator_kws={"num_byzantine": 1}, device="cpu",
                    log_path=str(tmp_path / "env"))
    sim.run(model="mlp", global_rounds=1, train_batch_size=4)
    kinds = [r["t"] for r in _trace(str(tmp_path / "env"))]
    assert "defense" in kinds and "metrics" in kinds and "audit" not in kinds
    assert set(sim.engine.last_diagnostics) == {"scores", "selected"}


def test_telemetry_off_writes_no_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("BLADES_TELEMETRY", "0")
    sim = Simulator(Synthetic(num_clients=6, train_size=120, test_size=30, cache=False),
                    aggregator="trimmedmean", aggregator_kws={"num_byzantine": 1},
                    device="cpu", log_path=str(tmp_path / "off"))
    sim.run(model="mlp", global_rounds=2, train_batch_size=4, collect_diagnostics=True,
            block_size=2)
    assert not os.path.exists(tmp_path / "off" / "telemetry.jsonl")
    assert sim.engine.last_diagnostics is not None  # the engine still computes it


def test_streaming_refuses_diagnostics_and_fallbacks_without_a_streaming_form(tmp_path):
    sim = Simulator(Synthetic(num_clients=6, train_size=120, test_size=30, cache=False),
                    aggregator="trimmedmean", aggregator_kws={"num_byzantine": 1},
                    device="cpu", log_path=str(tmp_path / "s"))
    run = dict(model="mlp", global_rounds=1, train_batch_size=4, streaming=True,
               client_chunks=2)
    with pytest.raises(ValueError, match="collect_diagnostics"):
        sim.run(collect_diagnostics=True, **run)
    with pytest.raises(ValueError, match="audit fallback"):
        sim.run(audit_monitor={"fallback_aggregator": "fltrust"}, **run)
    sim.run(audit_monitor={"fallback_aggregator": "median"}, round_metrics=True, **run)
    kinds = {r["t"] for r in _trace(str(tmp_path / "s"))}
    assert {"audit", "metrics"} <= kinds and "defense" not in kinds


@pytest.mark.parametrize("block_size", [1, 2])
def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path, block_size):
    sim = Simulator(Synthetic(num_clients=6, train_size=120, test_size=30, cache=False),
                    aggregator="mean", device="cpu", log_path=str(tmp_path / "p"))
    sim.run(model="mlp", global_rounds=4, train_batch_size=4, block_size=block_size,
            profile_dir=str(tmp_path / "prof"))
    profiles = [r for r in _trace(str(tmp_path / "p")) if r["t"] == "profile"]
    assert [(r["action"], r["ok"]) for r in profiles] == [("start", True), ("stop", True)]
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)


def test_a_failed_capture_is_a_record_not_a_failure(tmp_path, monkeypatch):
    rec = Recorder(path=None, enabled=True)

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    assert profiling.start_capture(str(tmp_path / "x"), rec) is None
    assert profiling.stop_capture(str(tmp_path / "x"), None, rec) is False
    got = [(r["action"], r["ok"], "error" in r) for r in rec.records if r["t"] == "profile"]
    assert got == [("start", False, True), ("stop", False, True)]
    assert profiling.memory_stats("cpu") is None
    assert profiling.profile_dir_from_env() is None or isinstance(
        profiling.profile_dir_from_env(), str)
