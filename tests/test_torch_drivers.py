"""The port's reference CLI (``blades_tpu_torch/examples/args.py``,
``cifar10.py``, ``main.py``) and the card's numeric settings
(``utils/platform.py``) against the JAX package's ``scripts/args.py``,
``scripts/cifar10.py`` and ``scripts/main.py``.

- ``parse_arguments`` on the same argv: every attribute of the JAX
  namespace equal, and the log directory's encoding letter for letter.
- Argument capture: a recorder stands in for ``Simulator`` where each
  driver looks it up (``tests/torch_capture_helpers.py``), and the
  constructor's and ``run``'s arguments are compared with models mapped
  to their class names, datasets to their class and settings and
  optimizer specs to their fields. Exact. The same for the examples'
  ``run_one``, sweep and ``run_cell`` (``convergence_config1``,
  ``simulation_on_mnist``, ``robustness_matrix``); the other examples'
  are in ``tests/test_torch_examples.py``.
- Every driver of the slice calls ``utils/platform.py:apply_numerics``
  (which sets the four switches and no others) before it builds its
  ``Simulator``, and without ``--device`` asks for the card and raises.
- The slice as a whole: the CLI's one-round CCT-2 run (ALIE, trimmed mean,
  K=4, Adam persisting) in both packages, the port handed the JAX run's
  initial parameters, its sampler's batch and, for CCT-2's attention
  dropout and DropPath, the same keep-masks on both sides (a fixed mask
  per site shape, patched into ``jax.random.bernoulli`` and the port
  engine's ``_draw_noise``). The global params agree within ``rtol=1e-3,
  atol=1e-5`` (the Adam bar, ``PERF.md`` section 2) on the coordinates
  where Adam is well conditioned (``torch_engine_helpers.
  _well_conditioned``); the stats logs have the same records and keys.
"""

import importlib
import importlib.util
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blades_tpu
import blades_tpu_torch
from blades_tpu_torch.examples import args as port_args
from blades_tpu_torch.examples import cifar10 as port_cifar10
from blades_tpu_torch.examples import main as port_main
from blades_tpu_torch.utils import platform
from torch_capture_helpers import JaxRecorder, PortRecorder, Recorder, captured, devices
from torch_capture_helpers import patch_simulators
from torch_engine_helpers import _well_conditioned
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
sys.path.insert(0, str(SCRIPTS))
sys.path.insert(0, str(ROOT))


def _jax_script(name: str):
    """``scripts/<name>.py`` as a module of its own (its ``from args
    import ...`` finds ``scripts/args.py``)."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_args = _jax_script("args")

ARGVS = [
    [],
    ["--agg", "trimmedmean", "--attack", "alie"],
    ["--agg", "krum", "--num_byzantine", "3", "--lr", "0.05"],
    ["--agg", "multikrum", "--num_byzantine", "5", "--batch_size", "16"],
    ["--agg", "dnc", "--seed", "7", "--dataset", "mnist"],
    ["--noniid", "--alpha", "0.5", "--agg", "median"],
    ["--attack", "ipm", "--agg", "geomed", "--global_round", "3", "--local_round", "2"],
    ["--use-cuda", "--num_actors", "4", "--num_gpus", "1", "--synthetic"],
    ["--attack", "minmax", "--agg", "unknown_agg", "--test_batch_size", "64",
     "--log_interval", "2", "--model", "mlp", "--num_clients", "12"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "defaults")
def test_parse_arguments_equals_jax(argv):
    """Every attribute the JAX namespace has, equal; ``log_dir`` is
    ``outputs/<dataset>/<encoding>`` with JAX's encoding letter for
    letter; ``--device`` is the port's own (None: the card)."""
    ours, theirs = port_args.parse_arguments(argv), jax_args.parse_arguments(argv)
    for name, value in vars(theirs).items():
        if name != "log_dir":
            assert getattr(ours, name) == value, name
    assert set(vars(ours)) == set(vars(theirs)) | {"device"}
    assert ours.device is None
    assert Path(ours.log_dir).name == Path(theirs.log_dir).name
    assert Path(ours.log_dir) == Path("outputs") / theirs.dataset / Path(theirs.log_dir).name
    assert not os.path.isabs(ours.log_dir)
    assert port_args.parse_arguments(argv + ["--device", "cpu"]).device == "cpu"


# -- argument capture ---------------------------------------------------------------


@pytest.fixture
def recorder(monkeypatch, tmp_path):
    """The recorders in place of both packages' ``Simulator`` wherever a
    driver looks it up; the working directory a temporary one."""
    monkeypatch.chdir(tmp_path)
    patch_simulators(monkeypatch)
    return monkeypatch


CIFAR_ARGVS = [
    ["--synthetic"],
    ["--agg", "trimmedmean", "--attack", "alie"],
    ["--synthetic", "--noniid", "--alpha", "0.5", "--model", "mlp", "--seed", "3",
     "--agg", "krum", "--num_byzantine", "2", "--num_clients", "6"],
    ["--synthetic", "--attack", "ipm", "--agg", "geomed", "--global_round", "5",
     "--local_round", "2", "--log_interval", "1", "--batch_size", "8", "--lr", "0.01"],
]


@pytest.mark.parametrize("argv", CIFAR_ARGVS, ids=lambda a: " ".join(a))
def test_cifar10_driver_arguments_equal_jax(recorder, argv):
    jax_cifar10 = _jax_script("cifar10")
    recorder.setattr(jax_cifar10, "Simulator", JaxRecorder)
    recorder.setattr(port_cifar10, "Simulator", PortRecorder)
    recorder.setattr(sys, "argv", ["cifar10.py", *argv])
    jax_cifar10.main()
    theirs = captured(Recorder.calls)
    Recorder.calls = []
    port_cifar10.main([*argv, "--device", "cpu"])
    assert devices(Recorder.calls) == ["cpu"]
    ours = captured(Recorder.calls)
    assert len(ours) == 1 and ours == theirs


@pytest.mark.parametrize("synthetic", [True, False], ids=["synthetic", "cifar10_files"])
def test_main_driver_arguments_equal_jax(recorder, synthetic):
    """``scripts/main.py`` runs at import (through ``runpy``); the port's
    ``main.main``: the same Simulator and the same 600-round run."""
    flags = ["--synthetic"] if synthetic else []
    recorder.setattr(sys, "argv", ["main.py", *flags])
    runpy.run_path(str(SCRIPTS / "main.py"), run_name="__main__")
    theirs = captured(Recorder.calls)
    Recorder.calls = []
    recorder.setattr(port_main, "Simulator", PortRecorder)
    port_main.main([*flags, "--device", "cpu"])
    assert devices(Recorder.calls) == ["cpu"]
    ours = captured(Recorder.calls)
    assert ours == theirs
    (_, kwargs, runs, _), = ours
    assert kwargs["aggregator"] == "geomed" and kwargs["attack"] == "ipm"
    assert runs[0][1]["global_rounds"] == 600 and runs[0][1]["model"] == "CCT"


def test_config1_run_one_arguments_equal_jax(recorder, tmp_path):
    from blades_tpu_torch.examples import convergence_config1 as ours_mod
    from examples import convergence_config1 as theirs_mod

    for mod, out, kw in ((theirs_mod, "jax", {}), (ours_mod, "port", {"device": "cpu"})):
        os.makedirs(tmp_path / out)
        for agg, attack in (("mean", None), ("trimmedmean", "alie")):
            tests, kind = mod.run_one(agg, str(tmp_path / "no_data"), str(tmp_path / out), 7,
                                      seed=2, attack=attack, **kw)
            assert kind == "synthetic" and tests[-1]["top1"] == 0.5
    n = len(Recorder.calls) // 2
    assert devices(Recorder.calls[n:]) == ["cpu", "cpu"]
    assert captured(Recorder.calls[n:]) == captured(Recorder.calls[:n])


def test_simulation_on_mnist_arguments_equal_jax(recorder, tmp_path):
    """The IPM sweep's five Simulators and runs; ``main`` parses
    ``sys.argv`` in JAX and its ``argv`` here."""
    from blades_tpu_torch.examples import simulation_on_mnist as ours_mod
    from examples import simulation_on_mnist as theirs_mod

    argv = ["--data-root", str(tmp_path / "no_data"), "--rounds", "3", "--seeds", "1", "2"]
    recorder.setattr(sys, "argv", ["simulation_on_mnist.py", *argv,
                                   "--out", str(tmp_path / "jax")])
    theirs_mod.main()
    n = len(Recorder.calls)
    summary = ours_mod.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert len(Recorder.calls) == 2 * n == 20
    assert devices(Recorder.calls[n:]) == ["cpu"] * n
    assert captured(Recorder.calls[n:]) == captured(Recorder.calls[:n])
    assert summary["final_top1"]["trimmedmean"]["n_seeds"] == 2


@pytest.mark.parametrize("attack,agg", [("none", "trimmedmean"), ("alie", "trimmedmean"),
                                        ("ipm", "krum"), ("signflipping", "median")])
def test_robustness_matrix_run_cell_arguments_equal_jax(recorder, tmp_path, attack, agg):
    from blades_tpu_torch.examples import robustness_matrix as ours_mod
    from examples import robustness_matrix as theirs_mod

    assert ours_mod.BUDGET_AGGS == theirs_mod.BUDGET_AGGS
    assert (ours_mod.K, ours_mod.BYZ) == (theirs_mod.K, theirs_mod.BYZ)
    ds = object()
    assert theirs_mod.run_cell(ds, attack, agg, 4, str(tmp_path / "jax"), seed=3) == 0.5
    assert ours_mod.run_cell(ds, attack, agg, 4, str(tmp_path / "port"), seed=3,
                             device="cpu") == 0.5
    assert devices(Recorder.calls[1:]) == ["cpu"]
    assert captured(Recorder.calls[1:]) == captured(Recorder.calls[:1])


# -- the card's numerics ------------------------------------------------------------------


def _other_switches():
    return {
        "cudnn_enabled": torch.backends.cudnn.enabled,
        "mkldnn_enabled": torch.backends.mkldnn.enabled,
        "fp16_reduction": torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
        "bf16_reduction": torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
        "threads": torch.get_num_threads(),
        "default_dtype": torch.get_default_dtype(),
    }


@pytest.mark.parametrize("flipped", [True, False], ids=["from_the_opposite", "from_set"])
def test_apply_numerics_sets_the_four_switches_and_no_others(flipped):
    """From every switch the other way, and again from where it left them."""
    saved = platform.numerics()
    try:
        torch.backends.cudnn.deterministic = not flipped
        torch.backends.cudnn.benchmark = flipped
        torch.backends.cuda.matmul.allow_tf32 = flipped
        torch.backends.cudnn.allow_tf32 = flipped
        others = _other_switches()
        platform.apply_numerics()
        assert platform.numerics() == {"cudnn_deterministic": True,
                                       "cudnn_benchmark": False, "matmul_allow_tf32": False,
                                       "cudnn_allow_tf32": False}
        assert _other_switches() == others
        assert torch.get_float32_matmul_precision() == "highest"  # TF32 off for matmuls
    finally:
        torch.backends.cudnn.deterministic = saved["cudnn_deterministic"]
        torch.backends.cudnn.benchmark = saved["cudnn_benchmark"]
        torch.backends.cuda.matmul.allow_tf32 = saved["matmul_allow_tf32"]
        torch.backends.cudnn.allow_tf32 = saved["cudnn_allow_tf32"]


class _Stop(Exception):
    pass


DRIVERS = {
    "cifar10": ["--synthetic"],
    "main": ["--synthetic"],
    "convergence_config1": ["--data-root", "no_data", "--out", "out"],
    "simulation_on_mnist": ["--data-root", "no_data", "--out", "out"],
    "robustness_matrix": ["--out", "out"],
    "customize_aggregator": [],
    "customize_attack": ["--synthetic"],
    "fltrust_example": [],
    "fault_injection": ["--out", "out"],
    "streaming_clients": ["--out", "out"],
    "async_fedbuff": ["--out", "out"],
    "metrics_trace": ["--out", "out"],
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_applies_the_numerics_before_its_simulator(monkeypatch, tmp_path, name):
    """Each driver of the slice calls ``apply_numerics`` first: before the
    Simulator is built (the stand-in stops the driver there)."""
    mod = importlib.import_module(f"blades_tpu_torch.examples.{name}")
    events = []

    class Stand(PortRecorder):
        def __init__(self, *a, **kw):
            events.append(("simulator", kw.get("device")))
            raise _Stop

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mod, "apply_numerics", lambda *a, **k: events.append(("numerics",)))
    monkeypatch.setattr(blades_tpu_torch, "Simulator", Stand, raising=False)
    if hasattr(mod, "Simulator"):
        monkeypatch.setattr(mod, "Simulator", Stand)
    with pytest.raises(_Stop):
        mod.main([*DRIVERS[name], "--device", "cpu"])
    assert events == [("numerics",), ("simulator", "cpu")]


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_without_device_each_driver_asks_for_the_card(tmp_path, monkeypatch, name):
    """No ``--device``: the card, which this machine lacks, so the driver
    raises before it runs anything on the CPU."""
    mod = importlib.import_module(f"blades_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CA_OUT", str(tmp_path))
    monkeypatch.setenv("FT_OUT", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(DRIVERS[name])
    assert not list(tmp_path.rglob("stats"))  # no run started


# -- the slice as a whole: the CLI's CCT-2 round ---------------------------------------------


CLI_ARGV = ["--synthetic", "--model", "cct", "--agg", "trimmedmean", "--attack", "alie",
            "--num_clients", "4", "--num_byzantine", "1", "--global_round", "1",
            "--local_round", "1", "--batch_size", "4"]
KEEP = 0.9  # CCT-2's attention dropout and DropPath keep 0.9


def _fixed_mask(shape, keep):
    """One keep-mask per site shape (trailing size-1 axes dropped: flax's
    DropPath asks ``[B, 1, 1]`` where the port's site is ``[B]``)."""
    shape = tuple(int(s) for s in shape)
    while len(shape) > 1 and shape[-1] == 1:
        shape = shape[:-1]
    return np.random.RandomState(7 * sum(shape) + len(shape)).rand(*shape) < keep


def _stats_shape(recs):
    return [(r["_meta"]["type"], sorted(r)) for r in recs]


def test_cli_cct2_round_matches_the_jax_driver(tmp_path, monkeypatch):
    from blades_tpu.core.engine import RoundEngine as JaxRoundEngine
    from blades_tpu.datasets.fl import FLDataset as JaxFL
    from blades_tpu.utils.logging import read_stats as jax_read_stats
    from blades_tpu_torch.core.engine import RoundEngine
    from blades_tpu_torch.datasets.fl import FLDataset
    from blades_tpu_torch.models import params_from_jax
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.utils.logging import read_stats
    from jax.flatten_util import ravel_pytree

    inits, batches, asked = [], [], []
    j_init, j_sample = JaxRoundEngine.init, JaxFL.sample_round
    real_bernoulli = jax.random.bernoulli

    def record_init(self, params, *a, **kw):
        inits.append(jax.tree_util.tree_map(np.asarray, params))
        return j_init(self, params, *a, **kw)

    def record_sample(self, *a, **kw):
        cx, cy = j_sample(self, *a, **kw)
        batches.append((np.asarray(cx), np.asarray(cy)))
        return cx, cy

    def bernoulli(key, p=0.5, shape=None, **kw):
        if shape is None or not np.isclose(float(p), KEEP):
            return real_bernoulli(key, p, shape, **kw)
        asked.append(tuple(shape))
        return jnp.asarray(_fixed_mask(shape, p).reshape(shape))

    jax_cifar10 = _jax_script("cifar10")
    j_parse = jax_cifar10.parse_arguments

    def parse_into_tmp():
        options = j_parse()
        options.log_dir = str(tmp_path / "jax_log" / Path(options.log_dir).name)
        return options

    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(JaxRoundEngine, "init", record_init)
    monkeypatch.setattr(JaxFL, "sample_round", record_sample)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax_cifar10, "parse_arguments", parse_into_tmp)
    monkeypatch.setattr(jax_cifar10, "Simulator", blades_tpu.simulator.Simulator)
    jax_sim = {}
    j_sim_init = blades_tpu.simulator.Simulator.__init__

    def keep_sim(self, *a, **kw):
        jax_sim["sim"] = self
        return j_sim_init(self, *a, **kw)

    monkeypatch.setattr(blades_tpu.simulator.Simulator, "__init__", keep_sim)
    monkeypatch.setattr(sys, "argv", ["cifar10.py", *CLI_ARGV])
    jax_cifar10.main()
    assert len(inits) == 1 and len(batches) == 1
    # flax drew every site's mask (two attention dropouts, two DropPaths) in
    # each trace of the round
    assert sorted(set(asked)) == [(4, 1, 1), (4, 2, 64, 64)] and len(asked) % 4 == 0, asked
    jstate = jax_sim["sim"].server.state
    jflat = np.asarray(ravel_pytree(jstate.params)[0])
    ok = _well_conditioned(jstate.client_opt_state[-1])

    p_init = RoundEngine.init
    handed = list(batches)

    def fixed_noise(self, noise_gen, steps, batch):
        sites = self.noise_sites(batch)
        return [{n: torch.from_numpy(_fixed_mask(shape, keep)).reshape(shape)
                 .expand(self.num_clients, *shape).contiguous()
                 for n, (shape, keep) in sites.items()} for _ in range(steps)]

    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr(RoundEngine, "init",
                        lambda self, params: p_init(self, params_from_jax(inits[0],
                                                                          self.layout)))
    monkeypatch.setattr(FLDataset, "sample_round",
                        lambda self, *a, **kw: tuple(torch.from_numpy(np.array(t))
                                                     for t in handed.pop(0)))
    monkeypatch.setattr(RoundEngine, "_draw_noise", fixed_noise)
    sim = port_cifar10.main([*CLI_ARGV, "--device", "cpu"])
    assert not handed and sim.engine.dim == 283_723 == jflat.size
    tflat = ravel(sim.server.state.params, sim.engine.layout).numpy()
    assert np.isfinite(tflat).all()
    assert ok.mean() > 0.5, ok.mean()
    np.testing.assert_allclose(tflat[ok], jflat[ok], rtol=1e-3, atol=1e-5)

    ours = read_stats(str(tmp_path / "port" / port_args.parse_arguments(CLI_ARGV).log_dir))
    theirs = jax_read_stats(str(tmp_path / "jax_log" / Path(
        jax_args.parse_arguments(CLI_ARGV).log_dir).name))
    assert _stats_shape(ours) == _stats_shape(theirs) and ours
    np.testing.assert_allclose(ours[0]["Loss"], theirs[0]["Loss"], rtol=1e-4)
