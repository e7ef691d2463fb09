"""The port's counterparts of the last single-card JAX examples (slice 15b),
each run on the CPU through its ``main``: ``telemetry_trace``,
``run_ledger``, ``defense_audit``, ``plot_comparing_aggregation_schemes``
and ``fedavg_ipm``.

- **Settings**: every ``Simulator``, ``run`` and other call equals the JAX
  example's, through the recorder of ``tests/torch_capture_helpers.py``
  (here with a trace that carries the run identity and a ``round`` span,
  and a fixed update matrix as ``engine.last_updates``).
- ``telemetry_trace`` at its own settings: ``mean_byz_trim_frac`` equals
  the value recomputed from the trace's own ``defense`` records, each of
  which trims ``2b`` slots a coordinate.
- ``run_ledger`` at its own settings, beside the JAX example: the three
  ``config_fingerprint`` values equal, the alert rules on the diverging run
  equal but for the wall-clock rule ``throughput_drop``, no alert on the
  healthy runs.
- ``defense_audit`` at its own settings on trials drawn once by JAX and
  handed to both: verdicts exact, ``worst_ratio`` within ``rtol=1e-4``;
  the audit's fallback on every breached round; the rerun bit for bit.
- ``plot_comparing_aggregation_schemes`` on the same ``[100, 2]`` matrix:
  every aggregate within f32 ``rtol=atol=1e-5`` (GeoMed and AutoGM
  ``rtol=1e-4, atol=1e-6``), the tags equal; DnC against JAX's DnC handed
  the port's draws.
- ``fedavg_ipm`` at 3 rounds of 2 local steps (30 of 10 by default: the
  collapse of the Krum arm and its capture streak are the card's,
  ``chip_smoke.py`` phase ``tools_examples``): on each round's
  ``last_updates`` the port's d^2 and d^4 Krum give the JAX Krum's
  aggregate within ``rtol=atol=1e-5`` and the same
  ``selected_is_byzantine`` (which of the bit-identical IPM rows is picked
  is not compared); ``reference: null`` where the reference is absent.

The summary JSONs have the JAX examples' keys, and no default output names
a file of the JAX package.
"""

import contextlib
import json
import math
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu_torch.examples import (
    defense_audit,
    fedavg_ipm,
    plot_comparing_aggregation_schemes,
    run_ledger,
    telemetry_trace,
)
from torch_capture_helpers import (
    JaxRecorder,
    PortRecorder,
    Recorder,
    captured,
    devices,
    patch_simulators,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-6)  # GeoMed, AutoGM: iterative, stopping rule on the host


def _run_jax_example(name: str, argv: list, monkeypatch) -> dict:
    """The JAX example run as a script (``runpy``, ``sys.argv`` its
    ``argv``); returns its globals."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")


def _records(path) -> list:
    return [json.loads(line) for line in open(path) if line.strip()]


# -- telemetry_trace ------------------------------------------------------------------


def test_telemetry_trace_byz_trim_frac_is_the_traces_own(tmp_path):
    summary = telemetry_trace.main(["--device", "cpu", "--out", str(tmp_path)])
    defense = [r for r in _records(tmp_path / "logs" / "telemetry.jsonl")
               if r["t"] == "defense"]
    assert [r["round"] for r in defense] == [1, 2]
    fracs = []
    for r in defense:
        counts = np.asarray(r["trim_counts"], dtype=np.float64)
        # each coordinate trims b from each end, b=2 of K=8 clients
        assert counts.sum() == 2 * r["trim_b"] * 59_850 and r["trim_b"] == 2
        fracs.append(counts[:2].sum() / counts.sum())  # clients 0-1 are byzantine
    assert summary["defense"]["mean_byz_trim_frac"] == pytest.approx(np.mean(fracs), abs=1e-12)
    assert summary["spans"]["round"]["count"] == 2
    assert {"round/sample", "round/dispatch", "round/sync"} <= set(summary["spans"])


# -- run_ledger -----------------------------------------------------------------------


def test_run_ledger_fingerprints_and_alerts_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("BLADES_LEDGER", str(tmp_path / "unused.jsonl"))  # restored after
    ours = run_ledger.main(["--device", "cpu", "--out", str(tmp_path / "port")])
    _run_jax_example("run_ledger", ["--out", str(tmp_path / "jax")], monkeypatch)
    theirs = {n: _records(tmp_path / "jax" / n / "telemetry.jsonl")
              for n in ("healthy", "rerun", "diverging")}
    assert ours["fingerprints"] == [theirs[n][0]["config_fingerprint"]
                                    for n in ("healthy", "rerun", "diverging")]
    assert ours["same_config_same_fingerprint"] and ours["diverging_differs"]
    # throughput_drop reads each package's own wall clock (a round 3x the
    # run's median); the rules on the records are held to JAX's
    assert [a["rule"] for a in ours["alerts"] if a["rule"] != "throughput_drop"] == [
        r["rule"] for r in theirs["diverging"]
        if r["t"] == "alert" and r["rule"] != "throughput_drop"] == ["loss_divergence"]
    assert ours["healthy_alerts"] == 0 and ours["stamped"]
    assert [r["outcome"] for r in ours["runs"]] == ["finished"] * 3
    assert ours["ledger"] == str(tmp_path / "port" / "ledger.jsonl")


# -- defense_audit --------------------------------------------------------------------


def test_defense_audit_cells_equal_jax_on_jax_trials(tmp_path, monkeypatch):
    from blades_tpu import audit as jaudit
    from blades_tpu.aggregators import get_aggregator as jax_get_aggregator

    import blades_tpu_torch.audit as port_audit

    k, d = 8, 32
    jtrials = jaudit.synthetic_honest(jax.random.PRNGKey(0), 2, k, d)
    expect = {}
    for name in defense_audit.DEFENSES:
        f = max(1, jaudit.nominal_f(name, k))
        agg = jax_get_aggregator(name, **jaudit.battery_kwargs(name, k, f))
        cell = jaudit.search_cell(agg, jtrials, f, ctx=jaudit.battery_ctx(None, k, d),
                                  grids=jaudit.QUICK_GRIDS)
        expect[name] = (f, float(cell["worst_ratio"]))
    handed = torch.from_numpy(np.array(jtrials))
    monkeypatch.setattr(port_audit, "synthetic_honest",
                        lambda gen, t, kk, dd, device="cpu": handed.to(device))
    out = defense_audit.main(["--device", "cpu", "--out", str(tmp_path)])
    for name, (f, ratio) in expect.items():
        cell = out["cells"][name]
        assert cell["f"] == f
        np.testing.assert_allclose(cell["worst_ratio"], ratio, rtol=1e-4)
        assert cell["verdict"] == ("CERTIFIED" if ratio <= 3.0 else "BREAKS")
    assert out["cells"]["mean"]["verdict"] == "BREAKS"
    assert all(out["cells"][n]["verdict"] == "CERTIFIED"
               for n in ("median", "krum", "centeredclipping"))
    assert [a["round"] for a in out["audits"]] == [1, 2, 3, 4]
    assert all(a["fallback_used"] == a["breach"] == 1 for a in out["audits"])
    assert math.isfinite(out["final_eval"]["Loss"]) and out["bit_reproducible"]


# -- plot_comparing_aggregation_schemes ---------------------------------------------


def test_plot_comparing_aggregates_and_tags_equal_jax(tmp_path, monkeypatch):
    from blades_tpu.aggregators import get_aggregator as jax_get_aggregator

    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.aggregators.dnc import draw_subspaces

    monkeypatch.setenv("AGG_PLOT_OUT", str(tmp_path / "jax.png"))
    jglobals = _run_jax_example("plot_comparing_aggregation_schemes", [], monkeypatch)
    ours = plot_comparing_aggregation_schemes.main(["--device", "cpu", "--out",
                                                    str(tmp_path / "port.png")])
    benign, outlier = plot_comparing_aggregation_schemes.points()
    np.testing.assert_array_equal(np.concatenate([benign, outlier]).astype(np.float32),
                                  np.asarray(jglobals["data"]))
    theirs = dict(jglobals["results"])
    assert sorted(ours) == sorted(theirs) and "trimmedmean" in ours and len(ours) == 14
    # DnC: JAX's handed the port's draws (its default generator, seed 0)
    dnc = get_aggregator("dnc")
    draws = draw_subspaces(torch.Generator().manual_seed(0), dnc.num_iters, 2,
                           min(dnc.sub_dim, 2), "cpu")
    queue = [a.numpy().astype(np.int32 if a.dtype == torch.int64 else np.float32)
             for pair in draws for a in pair]
    monkeypatch.setattr(jax.random, "choice", lambda key, *a, **k: jnp.asarray(queue.pop(0)))
    monkeypatch.setattr(jax.random, "normal", lambda key, *a, **k: jnp.asarray(queue.pop(0)))
    with jax.disable_jit():
        theirs["dnc"] = np.asarray(jax_get_aggregator("dnc")(jnp.asarray(jglobals["data"])))
    assert queue == []
    for name, rec in ours.items():
        tol = LOOP_TOL if name in ("geomed", "autogm") else TOL
        np.testing.assert_allclose(rec["aggregate"], theirs[name], **tol, err_msg=name)
        dist = np.linalg.norm(theirs[name] - benign.mean(0))
        assert rec["tag"] == ("ROBUST" if dist < 1.0 else "pulled"), name
    assert (tmp_path / "port.png").exists() == (tmp_path / "jax.png").exists()


@pytest.mark.parametrize("mod", [telemetry_trace, run_ledger, defense_audit,
                                 plot_comparing_aggregation_schemes, fedavg_ipm])
def test_default_outputs_are_the_ports_own(mod):
    """Each example writes under a git-ignored ``results/<name>_torch/``,
    never the JAX examples' committed ``results/<name>/``."""
    out = Path(mod.DEFAULT_OUT)
    top = out.parent if out.suffix else out
    assert top.parent == ROOT / "results" and top.name.endswith("_torch")
    assert f"{top.relative_to(ROOT).as_posix()}/" in (ROOT / ".gitignore").read_text()


# -- fedavg_ipm -----------------------------------------------------------------------


def test_fedavg_ipm_krum_adjudication_equals_jax_krum(tmp_path, monkeypatch):
    from blades_tpu.aggregators import get_aggregator as jax_get_aggregator

    from blades_tpu_torch.aggregators import get_aggregator

    byz = fedavg_ipm.BYZ
    make = fedavg_ipm.make_adjudicator
    held = []

    def checked(ref):
        adjudicate = make(ref)
        pairs = [(get_aggregator("krum", num_byzantine=byz, distance_power=p),
                  jax_get_aggregator("krum", num_byzantine=byz, distance_power=p), key)
                 for p, key in ((2, "selected_is_byzantine"),
                                (4, "parity_selected_is_byzantine"))]

        def adjudicate_and_hold(rnd, updates):
            row = adjudicate(rnd, updates)
            u = jnp.asarray(updates.numpy())
            for ours, theirs, key in pairs:
                got, _ = ours.aggregate(updates)
                np.testing.assert_allclose(got.numpy(), np.asarray(theirs(u)), **TOL)
                assert row[key] == (int(np.argmin(np.asarray(theirs.scores(u)))) < byz)
            held.append(rnd)
            return row

        return adjudicate_and_hold

    monkeypatch.setattr(fedavg_ipm, "make_adjudicator", checked)
    out = fedavg_ipm.main(["--device", "cpu", "--rounds", "3", "--steps", "2",
                           "--out", str(tmp_path)])
    assert held == [1, 2, 3]
    verdict = out["verdict"]
    assert verdict["rounds_checked"] == 3 and verdict["reference_available"] is False
    assert verdict["selection_agreement_with_reference"] is None
    assert 0.0 <= out["d2_d4_agreement"] <= 1.0
    assert sorted(out["summary"]["final_top1"]) == ["krum", "mean"]
    jax_dir = ROOT / "results" / "fedavg_ipm"
    for name in ("summary.json", "adjudication.json"):
        written = json.loads((tmp_path / name).read_text())
        assert sorted(written) == sorted(json.loads((jax_dir / name).read_text()))
    assert Path(fedavg_ipm.DEFAULT_OUT).name == "fedavg_ipm_torch"


# -- every Simulator call, against the JAX example's ----------------------------------


class _TraceRecorder(Recorder):
    """The recorder with a trace the examples read back (the run identity
    on every record, a ``round`` span) and a fixed ``[20, 8]`` update
    matrix, 8 identical IPM rows first, as ``engine.last_updates``."""

    def run(self, *args, **kwargs):
        out = super().run(*args, **kwargs)
        log = self.init[1].get("log_path")
        if log:
            ident = {"run_id": f"run{len(Recorder.calls)}", "attempt": 1,
                     "config_fingerprint": str(len(Recorder.calls))}
            path = Path(log) / "telemetry.jsonl"
            recs = [{**r, **ident} for r in _records(path)]
            recs.append({"t": "span", "path": "round", "dur_s": 0.0, **ident})
            path.write_text("".join(json.dumps(r) + "\n" for r in recs))
        return out

    @staticmethod
    def updates() -> np.ndarray:
        rs = np.random.RandomState(0)
        honest = rs.normal(0.0, 1.0, (12, 8)).astype(np.float32)
        ipm = np.repeat(-0.5 * honest.mean(0, keepdims=True), 8, 0)
        return np.concatenate([ipm, honest])


class _JaxTraceRecorder(_TraceRecorder, JaxRecorder):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.engine.last_updates = self.updates()


class _PortTraceRecorder(_TraceRecorder, PortRecorder):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.engine.last_updates = torch.from_numpy(self.updates())


#: each example's argv, its ``--out`` added
CAPTURED = {
    "telemetry_trace": ["--rounds", "2"],
    "run_ledger": ["--rounds", "4"],
    "defense_audit": ["--rounds", "4"],
    "fedavg_ipm": ["--rounds", "3", "--steps", "2"],
}


@pytest.mark.parametrize("name", sorted(CAPTURED))
def test_example_arguments_equal_jax(tmp_path, monkeypatch, name):
    """The recorders in place of both packages' ``Simulator``: the JAX
    example run as a script, the port's through its ``main``; every
    Simulator's constructor arguments, every ``run``'s (diagnostics, the
    audit's fallback, the persistent Adam and its schedule, the hook) and
    the other calls are equal, in order, and every port Simulator is on
    the device asked for."""
    import blades_tpu
    import blades_tpu.simulator as jsim

    import blades_tpu_torch

    monkeypatch.setenv("BLADES_LEDGER", str(tmp_path / "unused.jsonl"))  # restored after
    patch_simulators(monkeypatch)
    monkeypatch.setattr(blades_tpu, "Simulator", _JaxTraceRecorder, raising=False)
    monkeypatch.setattr(jsim, "Simulator", _JaxTraceRecorder)
    monkeypatch.setattr(blades_tpu_torch, "Simulator", _PortTraceRecorder, raising=False)
    mod = sys.modules[f"blades_tpu_torch.examples.{name}"]
    argv = CAPTURED[name]
    with contextlib.chdir(tmp_path):
        _run_jax_example(name, [*argv, "--out", str(tmp_path / "jax")], monkeypatch)
        n = len(Recorder.calls)
        result = mod.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert n > 0 and len(Recorder.calls) == 2 * n
    assert devices(Recorder.calls[n:]) == ["cpu"] * n
    assert captured(Recorder.calls[n:]) == captured(Recorder.calls[:n])
    if name == "fedavg_ipm":  # the fixed matrix: d^2 picks an IPM row, as JAX's does
        assert [r["selected_is_byzantine"] for r in result["verdict"]["per_round"]] == [
            True] * 3
