"""The port's counterparts of the JAX examples (slice 15a), each run on the
CPU through its ``main``: ``convergence_config1``, ``simulation_on_mnist``,
``robustness_matrix``, ``customize_aggregator``, ``customize_attack``,
``fltrust_example``, ``fault_injection``, ``streaming_clients``,
``async_fedbuff`` and ``metrics_trace`` (``cifar10`` and ``main`` are held
in ``tests/test_torch_drivers.py``).

Where an example's own settings take more than about 10 s on the CPU, it
runs with fewer rounds or a sub-grid, and its test says which claim the
reduced run cannot show; the card shows it (``chip_smoke.py``, phases
``drivers_config1`` and ``drivers_examples``, at the examples' own
settings). Every run here shows its seed-independent claims: finite
losses, the crash resumed bit for bit, degenerate async bit for bit the
sync run, the metric records identical under a block, the streaming peak
below the dense one, a bare callable and an Aggregator subclass of the
same function agreeing. The JSON summaries have the keys of the JAX
examples' own (their committed ``results/<name>/summary.json``), and
``evaluate_expectations`` equals the JAX package's on matrices the test
writes. The arithmetic the examples add (``customize_aggregator``'s
midhinge and norm-capped mean, ``customize_attack``'s three hooks) is
held to the JAX examples' on the same seeded inputs, and the settings of
the examples whose runs are not captured in ``tests/test_torch_drivers.py``
(every ``Simulator``, ``run`` and other call) equal the JAX examples'
through the recorder of ``tests/torch_capture_helpers.py``. No default
output of a driver names a file of the JAX package.
"""

import contextlib
import importlib
import json
import math
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blades_tpu_torch.examples import (
    async_fedbuff,
    convergence_config1,
    customize_aggregator,
    customize_attack,
    fault_injection,
    fltrust_example,
    metrics_trace,
    robustness_matrix,
    simulation_on_mnist,
    streaming_clients,
)
from blades_tpu_torch.utils.logging import read_stats
from torch_capture_helpers import PortRecorder, Recorder, captured, devices, patch_simulators
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _jax_summary(name: str) -> dict:
    """The JAX example's committed summary (``results/<name>/summary.json``)."""
    with open(ROOT / "results" / name / "summary.json") as f:
        return json.load(f)


def test_config1_runs_with_the_jax_summary_keys(tmp_path):
    """5 rounds, not 100: the three runs, their stats logs and the summary;
    the accuracy separation of 100 rounds is the card's
    (``drivers_config1``)."""
    summary = convergence_config1.main(["--device", "cpu", "--rounds", "5", "--data-root",
                                        str(tmp_path / "no_data"), "--out", str(tmp_path)])
    with open(tmp_path / "summary.json") as f:
        written = json.load(f)
    theirs = _jax_summary("config1")
    assert sorted(written) == sorted(theirs) and written["dataset"] == "synthetic"
    assert sorted(written["final_top1"]) == sorted(theirs["final_top1"])
    for label, stats in written["final_top1"].items():
        assert sorted(stats) == sorted(theirs["final_top1"][label])
        assert 0.0 <= stats["mean"] <= 1.0 and stats["n_seeds"] == 1
    assert all(math.isfinite(v) for v in summary["final_loss"].values())
    for tag in ("mean_noattack", "mean_alie", "trimmedmean_alie"):
        recs = read_stats(str(tmp_path / f"{tag}_logs"), "test")
        assert [r["Round"] for r in recs] == [5]
        assert (tmp_path / f"{tag}_stats").exists()


def test_plot_or_skip_says_why_and_skips(monkeypatch, capsys):
    """Where matplotlib does not import (the card machine), one line says
    so and nothing is drawn; where it does, the plot is called."""
    import sys

    drawn = []
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # its import raises ImportError
    assert convergence_config1.plot_or_skip(lambda *a: drawn.append(a), 1) is False
    out = capsys.readouterr().out.strip().splitlines()
    assert drawn == [] and len(out) == 1 and out[0].startswith("plot skipped: ")
    monkeypatch.undo()
    assert convergence_config1.plot_or_skip(lambda *a: drawn.append(a), 1) is True
    assert drawn == [(1,)]


def test_simulation_on_mnist_runs_with_the_jax_summary_keys(tmp_path, monkeypatch):
    """A sub-grid (mean and trimmed mean, 2 rounds, two seeds), not the 5
    aggregators for 10 rounds: the IPM reversal of each defense is the
    card's (``drivers_examples``)."""
    monkeypatch.setattr(simulation_on_mnist, "AGGS",
                        {a: simulation_on_mnist.AGGS[a] for a in ("mean", "trimmedmean")})
    monkeypatch.setattr(simulation_on_mnist, "plot_or_skip", lambda *a, **k: False)
    summary = simulation_on_mnist.main(["--device", "cpu", "--rounds", "2", "--seeds", "1", "2",
                                        "--data-root", str(tmp_path / "no_data"),
                                        "--out", str(tmp_path)])
    theirs = _jax_summary("mnist_sweep")
    with open(tmp_path / "summary.json") as f:
        assert sorted(json.load(f)) == sorted(theirs)
    assert sorted(summary["final_top1"]) == ["mean", "trimmedmean"]
    for agg, stats in summary["final_top1"].items():
        assert sorted(stats) == sorted(theirs["final_top1"][agg]) and stats["n_seeds"] == 2
    for tag in ("mean_logs", "trimmedmean_logs", "trimmedmean_s2_logs"):
        assert [r["Round"] for r in read_stats(str(tmp_path / tag), "test")] == [1, 2]


def test_robustness_matrix_merges_a_sub_grid_into_the_whole_matrix(tmp_path):
    """The trimmed-mean column under no attack and ALIE, 2 rounds, merged
    into a matrix the test writes for the other cells: the whole grid's
    summary (the JAX summary's keys), ``attack_success.json`` and the
    expectations' verdicts. The expectations are for 20 rounds; they are
    checked on the card (``drivers_examples``, the trimmed-mean column)."""
    rng = np.random.RandomState(0)
    matrix = {"_rounds": 2, "_seed": 1}
    for attack in robustness_matrix.ATTACKS:
        matrix[attack] = {agg: float(rng.rand()) for agg in robustness_matrix.AGGS}
    del matrix["none"]["trimmedmean"], matrix["alie"]["trimmedmean"]
    with open(tmp_path / "matrix.json", "w") as f:
        json.dump(matrix, f)
    merged = robustness_matrix.main(["--device", "cpu", "--rounds", "2", "--out", str(tmp_path),
                                     "--attacks", "none", "alie", "--aggs", "trimmedmean"])
    for attack in ("none", "alie"):
        assert 0.0 <= merged[attack]["trimmedmean"] <= 1.0
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert sorted(summary) == sorted(_jax_summary("matrix"))
    rows, ok = robustness_matrix.evaluate_expectations(merged)
    assert summary["cells"] == rows and summary["all_ok"] == ok
    with open(tmp_path / "attack_success.json") as f:
        success = json.load(f)["delta_top1"]
    assert success["alie"]["trimmedmean"] == round(
        merged["none"]["trimmedmean"] - merged["alie"]["trimmedmean"], 4)
    with pytest.raises(SystemExit, match="refusing to merge"):
        robustness_matrix.main(["--device", "cpu", "--rounds", "3", "--out", str(tmp_path),
                                "--attacks", "none", "--aggs", "mean"])


def _jax_matrix_module():
    return _jax_example("robustness_matrix")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluate_expectations_equals_jax(seed):
    """Pure Python: the port's table and verdicts are the JAX package's on a
    matrix the test writes (seed 3 leaves cells out, seed 2 puts cells on
    the rules' edges)."""
    jax_mod = _jax_matrix_module()
    assert robustness_matrix.EXPECTATIONS == jax_mod.EXPECTATIONS
    assert (robustness_matrix.ATTACKS, robustness_matrix.AGGS) == (jax_mod.ATTACKS,
                                                                   jax_mod.AGGS)
    rng = np.random.RandomState(seed)
    matrix = {a: {g: float(rng.rand()) for g in jax_mod.AGGS} for a in jax_mod.ATTACKS}
    if seed == 2:
        for attack, cells in jax_mod.EXPECTATIONS.items():
            for agg, rule in cells.items():
                matrix[attack][agg] = rule[1]
    if seed == 3:
        del matrix["none"]["median"], matrix["ipm"]["dnc"]
    assert robustness_matrix.evaluate_expectations(matrix) == jax_mod.evaluate_expectations(
        matrix)


@pytest.fixture
def ca_small(monkeypatch, tmp_path):
    """customize_aggregator at 2 rounds of 2 steps (20 of 10 by default),
    its logs in ``tmp_path``."""
    monkeypatch.setattr(customize_aggregator, "ROUNDS", 2)
    monkeypatch.setattr(customize_aggregator, "STEPS", 2)
    monkeypatch.setenv("CA_OUT", str(tmp_path))
    return tmp_path


def test_customize_aggregator_runs_both_surfaces(ca_small):
    top1 = customize_aggregator.main(["--device", "cpu"])
    assert sorted(top1) == ["callable", "mean", "subclass"]
    assert all(0.0 <= v <= 1.0 for v in top1.values())
    for tag in top1:
        train = read_stats(str(ca_small / f"ca_{tag}"), "train")
        assert len(train) == 2 and all(math.isfinite(r["Loss"]) for r in train)


def test_a_callable_and_a_subclass_of_the_same_function_agree(ca_small):
    """The bare callable, wrapped by ``aggregators/__init__.py:
    _wrap_callable``, and an Aggregator subclass computing the same
    midhinge give the same run, record for record."""
    from blades_tpu_torch.aggregators.base import Aggregator

    class Midhinge(Aggregator):
        def aggregate(self, updates, state=(), **ctx):
            return customize_aggregator.trimmed_like_callable(updates), state

    a = customize_aggregator.run(customize_aggregator.trimmed_like_callable, "callable",
                                 device="cpu")
    b = customize_aggregator.run(Midhinge(), "midhinge_subclass", device="cpu")
    assert a == b
    strip = lambda recs: [{k: v for k, v in r.items() if k != "_meta"} for r in recs]  # noqa
    assert strip(read_stats(str(ca_small / "ca_callable"))) == strip(
        read_stats(str(ca_small / "ca_midhinge_subclass")))


#: float32 against float32 in another library's reductions (a norm, a mean,
#: a percentile's interpolation): a few units in the last place
F32_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [5, 8, 12])
def test_trimmed_like_callable_equals_jax(k):
    """The midhinge on the same seeded ``[K, D]`` matrix (a band of tied
    columns among them): ``torch.quantile`` against ``jnp.percentile``."""
    jax_ca = _jax_example("customize_aggregator")
    rng = np.random.RandomState(k)
    x = rng.randn(k, 64).astype(np.float32)
    x[:, :8] = np.round(x[:, :8])
    ours = customize_aggregator.trimmed_like_callable(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_ca.trimmed_like_callable(x)),
                               **F32_TOL)


@pytest.mark.parametrize("k", [4, 7])
def test_norm_capped_mean_clips_and_moves_its_cap(k):
    """``init_state`` and three rounds of ``aggregate`` in each package, each
    threading its own cap, on the same seeded updates (norms on both sides
    of the cap, an even and an odd K for the median): the aggregate and
    the new cap of every round equal to the JAX example's."""
    jax_ca = _jax_example("customize_aggregator")
    ours, theirs = customize_aggregator.NormCappedMean(), jax_ca.NormCappedMean()
    o_cap, t_cap = ours.init_state(k, 16), theirs.init_state(k, 16)
    assert float(o_cap) == float(t_cap) == 1.0
    rng = np.random.RandomState(10 + k)
    for _ in range(3):
        u = rng.randn(k, 16)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        u = (u * float(t_cap) * rng.permutation(np.linspace(0.3, 2.5, k))[:, None]).astype(
            np.float32)
        norms = np.linalg.norm(u, axis=1)
        assert (norms > float(t_cap)).any() and (norms < float(t_cap)).any()
        o_out, o_cap = ours.aggregate(torch.from_numpy(u), o_cap)
        t_out, t_cap = theirs.aggregate(jnp.asarray(u), t_cap)
        np.testing.assert_allclose(o_out.numpy(), np.asarray(t_out), **F32_TOL)
        np.testing.assert_allclose(float(o_cap), float(t_cap), **F32_TOL)


def test_customize_attack_hooks_and_run(tmp_path, monkeypatch):
    """The three hooks against the JAX example's ``MaliciousAttack`` (its
    script run through ``runpy`` with the recorder as its ``Simulator``) on
    the same seeded inputs: ``on_batch`` and ``on_grads`` on each client's
    slice, as the JAX engine calls them under ``vmap``, and the port's on
    the whole client axis; ``on_updates`` on the ``[K, D]`` matrix. Then
    the example at 2 rounds of 2 steps (50 of 50 on the card)."""
    monkeypatch.chdir(tmp_path)
    patch_simulators(monkeypatch)
    theirs = _run_jax_example("customize_attack", ["--synthetic"], monkeypatch)[
        "MaliciousAttack"]()
    ours = customize_attack.MaliciousAttack()
    rng = np.random.RandomState(0)
    k = 6
    byz = np.array([True, False, True, True, False, False])
    x, y = rng.randn(k, 4, 3).astype(np.float32), rng.randint(0, 10, (k, 4)).astype(np.int32)
    t_x, t_y = jax.vmap(lambda x_, y_, b: theirs.on_batch(x_, y_, b, num_classes=10,
                                                          key=None))(x, y, byz)
    o_x, o_y = ours.on_batch(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(byz),
                             num_classes=10)
    assert np.array_equal(o_x.numpy(), np.asarray(t_x))
    assert np.array_equal(o_y.numpy(), np.asarray(t_y))
    grads = {"w": rng.randn(k, 2, 3).astype(np.float32), "b": rng.randn(k, 3).astype(np.float32)}
    t_g = jax.vmap(theirs.on_grads)(grads, byz)
    o_g = ours.on_grads({n: torch.from_numpy(g) for n, g in grads.items()},
                        torch.from_numpy(byz))
    for n in grads:
        assert np.array_equal(o_g[n].numpy(), np.asarray(t_g[n])), n
    updates = rng.randn(k, 5).astype(np.float32)
    t_u, t_state = theirs.on_updates(jnp.asarray(updates), jnp.asarray(byz), None)
    o_u, o_state = ours.on_updates(torch.from_numpy(updates), torch.from_numpy(byz))
    np.testing.assert_allclose(o_u.numpy(), np.asarray(t_u), **F32_TOL)
    assert o_state == t_state == ()

    monkeypatch.undo()
    monkeypatch.setattr(customize_attack, "ROUNDS", 2)
    monkeypatch.setattr(customize_attack, "STEPS", 2)
    monkeypatch.chdir(tmp_path)
    sim = customize_attack.main(["--synthetic", "--device", "cpu"])
    assert sim.num_byzantine == 5 and [c.is_byzantine() for c in sim.get_clients()] == (
        [True] * 5 + [False] * 5)
    train = read_stats(str(tmp_path / "outputs"), "train")
    assert len(train) == 2 and all(math.isfinite(r["Loss"]) for r in train)


# -- argument capture ---------------------------------------------------------------------


def _jax_example(name: str):
    """The JAX example ``examples/<name>.py`` as a module (its ``__main__``
    body not run)."""
    sys.path.insert(0, str(ROOT))
    return importlib.import_module(f"examples.{name}")


def _run_jax_example(name: str, argv: list, monkeypatch) -> dict:
    """The JAX example run as a script (``runpy``, ``sys.argv`` its
    ``argv``); returns its globals."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    try:
        return runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), e
        return {}


#: the examples whose settings the capture holds to the JAX example's: the
#: argv of each, the JAX example's ``--out`` or log root added
CAPTURED = {
    "fault_injection": ["--out"],
    "async_fedbuff": ["--out"],
    "streaming_clients": ["--out"],
    "metrics_trace": ["--out"],
    "customize_aggregator": [],
    "customize_attack": ["--synthetic"],
    "fltrust_example": [],
}


@pytest.mark.parametrize("name", sorted(CAPTURED))
def test_example_arguments_equal_jax(tmp_path, monkeypatch, name):
    """The recorder (``tests/torch_capture_helpers.py``) in place of both
    packages' ``Simulator``: the JAX example run as a script, the port's
    through its ``main``. Every Simulator's constructor arguments (the
    fault model's and the async configuration's fields among them), every
    ``run``'s (the kill hook, resume, streaming, block and metric flags),
    and the other calls (``evaluate``, ``register_attackers``,
    ``set_trusted_clients``) are equal, in order. FLTrust's own assertion
    (its margin over mean at 15 rounds or more) fails on the recorder's
    equal accuracies in both, after every call is recorded."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CA_OUT", str(tmp_path / "outputs"))
    monkeypatch.setenv("FT_OUT", str(tmp_path / "outputs"))
    patch_simulators(monkeypatch)
    mod = importlib.import_module(f"blades_tpu_torch.examples.{name}")
    if hasattr(mod, "Simulator"):
        monkeypatch.setattr(mod, "Simulator", PortRecorder)
    flags = CAPTURED[name]
    jax_argv = [*flags, str(tmp_path / "jax")] if flags == ["--out"] else flags
    port_argv = [*flags, str(tmp_path / "port")] if flags == ["--out"] else flags
    margin = (pytest.raises(AssertionError, match="should decisively beat")
              if name == "fltrust_example" else contextlib.nullcontext())
    with margin:
        _run_jax_example(name, jax_argv, monkeypatch)
    n = len(Recorder.calls)
    with margin:
        mod.main([*port_argv, "--device", "cpu"])
    assert n > 0 and len(Recorder.calls) == 2 * n
    assert devices(Recorder.calls[n:]) == ["cpu"] * n
    assert captured(Recorder.calls[n:]) == captured(Recorder.calls[:n])


def test_fltrust_example_runs(tmp_path, monkeypatch):
    """2 rounds of 1 step (20 of 10 by default): FLTrust's margin over mean
    needs 15 rounds or more and is checked on the card
    (``drivers_examples``); here both runs and the trusted root."""
    monkeypatch.setattr(fltrust_example, "ROUNDS", 2)
    monkeypatch.setattr(fltrust_example, "STEPS", 1)
    monkeypatch.setenv("FT_OUT", str(tmp_path))
    top1 = fltrust_example.main(["--device", "cpu"])
    assert sorted(top1) == ["fltrust", "mean"] and all(0 <= v <= 1 for v in top1.values())
    for tag in top1:
        assert len(read_stats(str(tmp_path / f"ft_{tag}"), "test")) == 1


def test_fault_injection_at_its_own_settings(tmp_path):
    """4 rounds under 30% dropout and 2 NaN clients with krum, median and
    trimmed mean (its masked form): finite losses, NaN rows excluded every
    round, the crash autosave and the resume bit for bit."""
    report = fault_injection.main(["--device", "cpu", "--out", str(tmp_path)])
    assert sorted(report["aggs"]) == ["krum", "median", "trimmedmean"]
    for agg, rec in report["aggs"].items():
        assert math.isfinite(rec["loss"]) and len(rec["participants"]) == 4
        assert rec["nan_rows_excluded"] > 0 and rec["dropped"] > 0
        faults = fault_injection.fault_counts(str(tmp_path / agg))
        assert [r["round"] for r in faults] == [1, 2, 3, 4]
    assert report["autosave_written"] and report["resume_bit_exact"]


def test_streaming_clients_at_its_own_settings(tmp_path):
    """3 rounds at K=24 in 5 chunks: the dense run's peak is the ``[K, D]``
    matrix, the streaming run's one ``[chunk, D]`` slab (``peak_update_
    bytes`` on the round records); no ``memory`` record on the CPU."""
    report = streaming_clients.main(["--device", "cpu", "--out", str(tmp_path)])
    d = 59_850
    dense, stream = report["dense"]["gauges"], report["streaming"]["gauges"]
    assert dense["peak_update_bytes"] == 24 * d * 4 and dense["streaming"] == 0
    assert stream["peak_update_bytes"] == stream["chunk_size"] * d * 4 and stream["streaming"]
    assert stream["chunk_size"] == 5 and stream["client_chunks"] == 5
    assert report["dense"]["memory"] == report["streaming"]["memory"] == []


def test_async_fedbuff_at_its_own_settings(tmp_path):
    report = async_fedbuff.main(["--device", "cpu", "--out", str(tmp_path)])
    assert report["degenerate_bit_exact"]
    assert math.isfinite(report["fedbuff"]["loss"]) and report["fedbuff"]["ticks"] == 6
    assert 0 < report["fedbuff"]["fires"] <= 6
    assert sorted(report["modes"]) == ["constant", "cutoff", "polynomial"]
    assert all(math.isfinite(m["loss"]) for m in report["modes"].values())
    assert report["modes"]["constant"]["stale_excluded"] == 0


def test_metrics_trace_at_its_own_settings(tmp_path):
    """4 rounds, round by round and as one block of 4: the ``metrics``
    records identical, the sign flippers' cosine below the honest one."""
    report = metrics_trace.main(["--device", "cpu", "--out", str(tmp_path)])
    assert report["identical_under_block"] and report["rounds"] == 4
    assert report["byz_away"] == 4
    seq, blk = report["per_round"]["metrics"], report["block"]["metrics"]
    assert [m["round"] for m in seq] == [m["round"] for m in blk] == [1, 2, 3, 4]
    assert report["per_round"]["gauges"]["engine.peak_update_bytes"] == 8 * 59_850 * 4


# -- defaults ---------------------------------------------------------------------------


#: the JAX examples' default outputs, committed in the repository
JAX_OUTPUTS = ("results/config1", "docs/assets/config1_convergence.png", "results/mnist_sweep",
               "results/matrix", "results/faults_demo", "results/async_demo",
               "results/metrics_demo")

PORT_OUTPUTS = {
    convergence_config1: "results/config1_torch",
    simulation_on_mnist: "results/mnist_sweep_torch",
    robustness_matrix: "results/matrix_torch",
    fault_injection: "results/faults_demo_torch",
    async_fedbuff: "results/async_demo_torch",
    metrics_trace: "results/metrics_demo_torch",
}


@pytest.mark.parametrize("mod", sorted(PORT_OUTPUTS, key=lambda m: m.__name__),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_default_outputs_name_no_tracked_file(mod):
    """Each example's default ``--out`` is its own git-ignored
    ``results/<name>_torch/``, none of the JAX examples' committed outputs
    (``convergence_config1``'s plot goes into it, not ``docs/assets``);
    where this is a git checkout, git tracks nothing under it."""
    out = Path(mod.DEFAULT_OUT).resolve()
    assert out == (ROOT / PORT_OUTPUTS[mod]).resolve()
    for committed in JAX_OUTPUTS:
        c = (ROOT / committed).resolve()
        assert out != c and c not in out.parents and out not in c.parents
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert f"{PORT_OUTPUTS[mod]}/" in ignored
    if (ROOT / ".git").exists():
        tracked = subprocess.run(["git", "ls-files", "--", str(out)], cwd=ROOT,
                                 capture_output=True, text=True, check=True).stdout
        assert tracked == ""


def test_relative_defaults_stay_under_ignored_outputs():
    """The CLI's log directory, the streaming demo's ``--out`` and the
    ``./outputs`` of the others are under ``outputs/``, which git
    ignores."""
    from blades_tpu_torch.examples.args import parse_arguments

    assert Path(parse_arguments([]).log_dir).parts[0] == "outputs"
    import inspect

    assert '"outputs/streaming_clients"' in inspect.getsource(streaming_clients.main)
    for mod in (customize_aggregator, fltrust_example):
        assert '"./outputs"' in inspect.getsource(mod.run)
    assert "outputs/" in (ROOT / ".gitignore").read_text().splitlines()
