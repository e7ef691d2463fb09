"""Build provenance of the port (``blades_tpu_torch/telemetry/programs.py``)
against the JAX package's registry (``blades_tpu/telemetry/programs.py``),
the port's form of ``tests/test_programs.py``.

Every increment goes through ``recorder.count_process`` under the port's
counter names (``cuda.kernel_build_s``, ``cuda.kernel_builds``,
``cuda.graph_capture_s``, ``cuda.graph_captures``, ``cuda.kernel_reuses``):

- the registry's semantics: outcomes and causes, one warm record a
  program, evictions, nested scopes, the bounded ledger, a disabled
  recorder, ``reset``, and the records against the schema;
- one sequence of scopes and increments through both registries, under
  the mapped names, gives the same outcomes and causes;
- the tiling invariant: attributed plus unattributed seconds equal the
  process mirror's, on a ``Simulator`` run whose round builds a kernel;
  the warm repeat from the ``EngineCache`` emits no build record;
- the ``memory`` record: on a CUDA device its allocator fields, on the CPU
  nothing.
"""

import json
import os

import pytest
import torch

from blades_tpu.telemetry import programs as jax_programs
from blades_tpu_torch.sweeps import EngineCache
from blades_tpu_torch.telemetry import Recorder, get_recorder, programs, set_recorder
from blades_tpu_torch.telemetry import profiling
from blades_tpu_torch.telemetry import recorder as recorder_mod
from blades_tpu_torch.telemetry.recorder import count_process
from blades_tpu_torch.telemetry.schema import validate_records
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

#: the port's counter -> the JAX counter of the same record field
PORT_TO_JAX = {
    "cuda.kernel_build_s": "xla.compile_s",
    "cuda.kernel_builds": "xla.compiles",
    "cuda.graph_capture_s": "xla.trace_s",
    "cuda.graph_captures": "xla.compiles",
    "cuda.kernel_reuses": "xla.cache_hits",
}


@pytest.fixture(autouse=True)
def _fresh_registry():
    prev = get_recorder()
    programs.reset()
    yield
    set_recorder(prev)
    programs.reset()


def _build(seconds=0.5, captures=0):
    """One kernel build (and ``captures`` graph captures) in the open scope."""
    count_process("cuda.kernel_build_s", seconds)
    count_process("cuda.kernel_builds")
    for _ in range(captures):
        count_process("cuda.graph_capture_s", 0.2)
        count_process("cuda.graph_captures")


# -- the registry's semantics ----------------------------------------------------------


def test_cold_build_emits_program_record_with_cause():
    rec = Recorder(enabled=True)
    set_recorder(rec)
    with programs.watch("t/round", shapes=(4, 8), donation=(0,)):
        _build(captures=1)
    (r,) = [r for r in rec.records if r["t"] == "program"]
    assert r["program"] == "t/round" and r["outcome"] == "cold"
    assert r["cause"] == "new-fingerprint"
    assert r["compiles"] == 2 and r["compile_s"] == 0.5 and r["trace_s"] == 0.2
    assert r["fingerprint"] == programs.derive_fingerprint(
        "t/round", programs._key_str((4, 8)), programs._key_str((0,)))
    assert len(r["fingerprint"]) == 12


def test_warm_reuse_emits_at_most_once_per_program():
    rec = Recorder(enabled=True)
    set_recorder(rec)
    with programs.watch("t/round", fingerprint="fp1"):
        _build()
    for _ in range(3):
        with programs.watch("t/round", fingerprint="fp1"):
            pass
    recs = [r for r in rec.records if r["t"] == "program"]
    assert [r["outcome"] for r in recs] == ["cold", "warm-reuse"]
    assert "cause" not in recs[1]
    snap = programs.snapshot()
    assert snap["programs"]["fp1"]["warm"] == 3 and snap["programs"]["fp1"]["builds"] == 1


def test_persistent_cache_hit_is_a_kernel_library_found_on_disk():
    with programs.watch("t/cached", fingerprint="fpc"):
        count_process("cuda.kernel_reuses")
    ev = programs.events()[-1]
    assert ev["outcome"] == "persistent-cache-hit" and ev["cause"] == "new-fingerprint"
    assert ev["cache_hits"] == 1 and "compiles" not in ev


@pytest.mark.parametrize("second,third,causes", [
    ((8,), (8,), ["new-fingerprint", "shape-change", "donation-change"]),
    # the same identity built again: its executable must have been lost
    ((4,), (4,), ["new-fingerprint", "cache-eviction", "donation-change"]),
])
def test_shape_and_donation_change_causes(second, third, causes):
    with programs.watch("t/f", shapes=(4,), donation=(0,)):
        _build()
    with programs.watch("t/f", shapes=second, donation=(0,)):
        _build()
    with programs.watch("t/f", shapes=third, donation=()):
        _build()
    assert [e["cause"] for e in programs.events()] == causes


def test_eviction_cause_via_note_eviction_and_the_engine_cache():
    with programs.watch("t/g", fingerprint="fpg", shapes=(4,)):
        _build()
    programs.note_eviction("fpg")
    with programs.watch("t/g", fingerprint="fpg", shapes=(5,)):
        _build()
    assert programs.events()[-1]["cause"] == "cache-eviction"
    cache = EngineCache(max_entries=2)
    cache.put("a", 1, build_s=0.5)
    cache.put("b", 2, build_s=0.7)
    assert cache.get("a") == 1
    cache.put("c", 3)  # evicts b, the least recently used
    assert cache.stats()["evictions"] == 1 and cache.get("b") is None
    with programs.watch("t/engine", fingerprint="b"):
        _build()
    assert programs.events()[-1]["cause"] == "cache-eviction"


def test_cause_hint_wins_for_first_build():
    with programs.watch("t/eval", cause_hint="first-eval"):
        _build()
    assert programs.events()[-1]["cause"] == "first-eval"


def test_unattributed_bucket_and_coverage():
    with programs.watch("t/h"):
        count_process("cuda.kernel_build_s", 0.9)
        count_process("cuda.kernel_builds")
    count_process("cuda.graph_capture_s", 0.1)  # no scope open
    snap = programs.snapshot()
    assert snap["attributed"]["compile_s"] == pytest.approx(0.9)
    assert snap["unattributed"]["trace_s"] == pytest.approx(0.1)
    assert snap["coverage"] == pytest.approx(0.9)


def test_nested_scopes_attribute_to_innermost():
    with programs.watch("t/outer", fingerprint="fpo"):
        with programs.watch("t/inner", fingerprint="fpi"):
            _build()
    snap = programs.snapshot()
    assert snap["programs"]["fpi"]["builds"] == 1 and snap["programs"]["fpo"]["builds"] == 0


def test_events_ledger_is_bounded(monkeypatch):
    monkeypatch.setattr(programs, "_MAX_EVENTS", 8)
    for i in range(20):
        with programs.watch(f"t/p{i}"):
            _build()
    assert len(programs.events()) <= 8 and programs.snapshot()["dropped"] > 0
    assert programs.events()[-1]["program"] == "t/p19"


def test_disabled_recorder_emits_nothing_but_ledger_keeps_accounting():
    set_recorder(None)
    with programs.watch("t/quiet", fingerprint="fpq"):
        _build()
    assert get_recorder().records == []
    assert programs.events()[-1]["fingerprint"] == "fpq"
    assert programs.snapshot()["programs"]["fpq"]["builds"] == 1


def test_reset_clears_everything():
    with programs.watch("t/r"):
        _build()
    count_process("cuda.kernel_build_s", 0.1)
    programs.reset()
    snap = programs.snapshot()
    assert snap["programs"] == {} and snap["emitted"] == 0
    assert snap["attributed"] == {} and snap["unattributed"] == {} and snap["coverage"] == 1.0


def test_program_cache_stats_and_memory_records_validate_against_schema():
    rec = Recorder(enabled=True)
    set_recorder(rec)
    with programs.watch("t/s", shapes=(4,), donation=(0,)):
        _build(captures=1)
        count_process("cuda.kernel_reuses")
    cache = EngineCache()
    cache.put("k1", object(), build_s=0.5)
    cache.get("k1")
    rec.event("cache_stats", ts=1.0, **cache.stats())
    state = (torch.zeros(10), {"w": torch.zeros(3, 4)})
    fields = profiling.record_program_profile(
        "block", "cuda", argument_bytes=profiling.tensor_bytes(state), output_bytes=8,
        temp_bytes=1 << 20, rec=rec)
    assert fields == {"argument_bytes": 88, "output_bytes": 8, "temp_bytes": 1 << 20}
    assert profiling.record_program_profile("round", "cuda", argument_bytes=1, output_bytes=2,
                                            rec=rec) == {"argument_bytes": 1, "output_bytes": 2}
    assert [r["t"] for r in rec.records].count("memory") == 2
    assert validate_records(rec.records) == []


# -- the two registries side by side ---------------------------------------------------


def _sequence(watch, note_eviction, feed):
    """One script of scopes and increments; ``feed(port_name, inc)``."""
    with watch("s/round", shapes=(4, 8), donation=(0,)):
        feed("cuda.kernel_reuses", 1)
    with watch("s/round", shapes=(4, 8), donation=(0,)):
        pass
    with watch("s/block", fingerprint="fpb", shapes=(2,)):
        feed("cuda.graph_capture_s", 0.3)
        feed("cuda.graph_captures", 1)
    with watch("s/block", fingerprint="fpb", shapes=(3,)):
        feed("cuda.graph_capture_s", 0.2)
        feed("cuda.graph_captures", 1)
    with watch("s/eval", cause_hint="first-eval"):
        with watch("s/kernel", fingerprint="fpk"):
            feed("cuda.kernel_build_s", 0.4)
            feed("cuda.kernel_builds", 1)
    note_eviction("fpk")
    with watch("s/kernel", fingerprint="fpk", shapes=(9,)):
        feed("cuda.kernel_build_s", 0.4)
        feed("cuda.kernel_builds", 1)
    with watch("s/block", fingerprint="fpb", shapes=(3,), donation=()):
        feed("cuda.graph_capture_s", 0.1)
        feed("cuda.graph_captures", 1)
    feed("cuda.kernel_build_s", 0.05)  # outside every scope


def test_the_port_and_jax_registries_agree_on_one_sequence():
    jax_programs.reset()
    try:
        _sequence(programs.watch, programs.note_eviction, count_process)
        _sequence(jax_programs.watch, jax_programs.note_eviction,
                  lambda name, inc: jax_programs._observe(PORT_TO_JAX[name], inc))
        ours, theirs = programs.events(), jax_programs.events()
        key = lambda e: (e["program"], e["outcome"], e.get("cause"), e.get("shapes"))  # noqa: E731
        assert [key(e) for e in ours] == [key(e) for e in theirs]
        assert [e["fingerprint"] for e in ours] == [e["fingerprint"] for e in theirs]
        for a, b in zip(ours, theirs):
            assert {k: a[k] for k in ("trace_s", "compile_s", "compiles", "cache_hits")
                    if k in a} == {k: b[k] for k in ("trace_s", "compile_s", "compiles",
                                                     "cache_hits") if k in b}
        snap, jsnap = programs.snapshot(), jax_programs.snapshot()
        assert snap["coverage"] == jsnap["coverage"]
        for fp, entry in snap["programs"].items():
            assert {k: entry[k] for k in ("builds", "warm", "last_outcome")} == {
                k: jsnap["programs"][fp][k] for k in ("builds", "warm", "last_outcome")}
    finally:
        jax_programs.reset()


# -- the tiling invariant on a run ------------------------------------------------------


def test_tiling_invariant_on_a_simulator_run_and_a_warm_repeat(tmp_path, monkeypatch):
    """A ``Simulator`` run whose first round builds a kernel and captures a
    graph (the counters fed where ``ops/_build.py`` and ``core/graphs.py``
    feed them on the card) and a build outside every scope: attributed
    plus unattributed seconds equal the process mirror's delta; the
    round's record is ``cold`` under the ``EngineCache`` key, the model's
    init, the engine's construction, the sampler and the evaluation are
    warm-reuse records; the warm repeat emits no build record."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.core.engine import RoundEngine
    from blades_tpu_torch.datasets import Synthetic

    real_round = RoundEngine._round
    built = []

    def round_that_builds(self, *a, **kw):
        if not built:
            built.append(1)
            _build(seconds=0.75, captures=1)
        return real_round(self, *a, **kw)

    monkeypatch.setattr(RoundEngine, "_round", round_that_builds)
    before = recorder_mod.process_counters()
    programs.reset()
    count_process("cuda.kernel_build_s", 0.125)  # no scope open
    ds = Synthetic(num_clients=4, train_size=64, test_size=32, noise=0.3, cache=False)
    cache = EngineCache()
    sim = Simulator(ds, log_path=str(tmp_path / "out"), seed=0, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": 1}, device="cpu")
    sim.run("mlp", global_rounds=2, local_steps=1, client_lr=0.2, validate_interval=1,
            train_batch_size=8, engine_cache=cache)
    after = recorder_mod.process_counters()
    mirror = sum(after.get(k, 0.0) - before.get(k, 0.0)
                 for k in ("cuda.kernel_build_s", "cuda.graph_capture_s"))
    snap = programs.snapshot()
    attributed = sum(snap["attributed"].get(k, 0.0) for k in programs.SECONDS_FIELDS)
    unattributed = sum(snap["unattributed"].get(k, 0.0) for k in programs.SECONDS_FIELDS)
    assert mirror == pytest.approx(1.075)
    assert attributed + unattributed == pytest.approx(mirror)
    assert attributed == pytest.approx(0.95) and unattributed == pytest.approx(0.125)
    events = programs.events()
    by_outcome = {(e["program"], e["outcome"]) for e in events}
    assert ("engine/round", "cold") in by_outcome
    (round_rec,) = [e for e in events
                    if e["program"] == "engine/round" and e["outcome"] == "cold"]
    key = next(iter(cache.stats()["by_key"]))
    assert round_rec["fingerprint"] == f"{key}:round" and round_rec["cause"] == "new-fingerprint"
    assert round_rec["compiles"] == 2
    for label in ("model/mlp/init", "engine/construct", "engine/init",
                  "dataset/sample_round", "engine/eval_per_sample"):
        assert (label, "warm-reuse") in by_outcome, label
    trace = [json.loads(line) for line in open(tmp_path / "out" / "telemetry.jsonl")]
    assert [r for r in trace if r["t"] == "program"] == [
        {"t": "program", **e, "run_id": trace[0]["run_id"], "attempt": trace[0]["attempt"]}
        for e in events]
    assert not [r for r in trace if r["t"] == "memory"]  # the CPU: no allocator record
    assert validate_records(trace) == []

    n = len(events)
    sim2 = Simulator(ds, log_path=str(tmp_path / "out2"), seed=0, aggregator="trimmedmean",
                     aggregator_kws={"num_byzantine": 1}, device="cpu")
    sim2.run("mlp", global_rounds=1, local_steps=1, client_lr=0.2, validate_interval=1,
             train_batch_size=8, engine_cache=cache)
    assert programs.events()[n:] == []
    assert cache.stats()["hits"] == 1
    assert os.path.exists(tmp_path / "out2" / "telemetry.jsonl")
