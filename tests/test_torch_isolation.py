"""The port stands alone: ``blades_tpu_torch``, ``chip_smoke.py`` and
``kernel_stages.py`` import nothing of JAX, flax, optax or the JAX package, and a round run through the
port leaves no ``jax`` in ``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from torch_threads_helpers import worker_threads

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "blades_tpu")


def _subprocess_env() -> dict:
    """A subprocess round's environment: this checkout on the path, and
    the test worker's share of the cores for torch's threads
    (``tests/torch_threads_helpers.py``)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = str(worker_threads())
    return env


def _port_files():
    files = sorted((ROOT / "blades_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "kernel_stages.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__", "importorskip")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0]


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files[-2:])
    bad = {
        str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    assert {f: mods for f, mods in bad.items() if mods} == {}


def test_round_in_subprocess_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from blades_tpu_torch import Simulator\n"
        "from blades_tpu_torch.datasets import Synthetic\n"
        "ds = Synthetic(num_clients=6, train_size=120, test_size=30, cache=False)\n"
        "sim = Simulator(ds, attack='alie', num_byzantine=2, aggregator='trimmedmean',\n"
        f"                device='cpu', log_path={str(tmp_path / 'out')!r})\n"
        "sim.run(model='mlp', global_rounds=1, train_batch_size=4)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_streaming_module_is_covered_and_a_streaming_round_loads_no_jax(tmp_path):
    """``ops/streaming.py`` is among the checked sources, and a streaming
    round run through the port leaves no ``jax`` in ``sys.modules``."""
    assert ROOT / "blades_tpu_torch" / "ops" / "streaming.py" in _port_files()
    code = (
        "import sys\n"
        "from blades_tpu_torch import Simulator\n"
        "from blades_tpu_torch.datasets import Synthetic\n"
        "ds = Synthetic(num_clients=7, train_size=140, test_size=30, cache=False)\n"
        "sim = Simulator(ds, attack='noise', num_byzantine=2, aggregator='trimmedmean',\n"
        "                aggregator_kws={'num_byzantine': 2}, device='cpu',\n"
        f"                log_path={str(tmp_path / 'out')!r})\n"
        "sim.run(model='mlp', global_rounds=1, train_batch_size=4, streaming=True,\n"
        "        client_chunks=2, fault_model={'corrupt_rate': 0.3, 'corrupt_mode': 'bitflip'})\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_asyncfl_package_is_covered_and_an_async_round_loads_no_jax(tmp_path):
    """``asyncfl/`` is among the checked sources, and buffered-async rounds
    with persistent Adam state and registered attackers run through the
    port leave no ``jax`` in ``sys.modules``."""
    files = _port_files()
    for name in ("__init__.py", "arrivals.py", "buffer.py", "engine.py"):
        assert ROOT / "blades_tpu_torch" / "asyncfl" / name in files
    code = (
        "import sys\n"
        "from blades_tpu_torch import ClientOptSpec, Simulator\n"
        "from blades_tpu_torch.attackers import get_attack\n"
        "from blades_tpu_torch.client import ByzantineClient\n"
        "from blades_tpu_torch.datasets import Synthetic\n"
        "ds = Synthetic(num_clients=6, train_size=120, test_size=30, cache=False)\n"
        "sim = Simulator(ds, aggregator='asyncmean', device='cpu',\n"
        f"                log_path={str(tmp_path / 'out')!r})\n"
        "sim.register_attackers([ByzantineClient(attack=get_attack('signflipping'))])\n"
        "sim.run(model='mlp', global_rounds=2, train_batch_size=4,\n"
        "        client_optimizer=ClientOptSpec(name='adam', persist=True),\n"
        "        async_config={'buffer_m': 3, 'arrivals': {'kind': 'uniform', 'max_delay': 2}})\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_data_and_checkpoint_modules_are_covered_and_a_resumed_cifar_run_loads_no_jax(
        tmp_path):
    """The loaders, ``augment.py``, ``utils/checkpoint.py``, ``version.py``
    and the mini example are among the checked sources, and a CIFAR-10 run
    from pickle files, crashed and resumed from its autosave, leaves no
    ``jax`` in ``sys.modules``."""
    files = _port_files()
    pkg = ROOT / "blades_tpu_torch"
    for rel in ("datasets/augment.py", "datasets/mnist.py", "datasets/cifar10.py",
                "datasets/cifar100.py", "datasets/custom.py", "utils/checkpoint.py",
                "version.py", "examples/mini_example.py"):
        assert pkg / rel in files
    code = (
        "import os, pickle, sys\n"
        "import numpy as np\n"
        "from blades_tpu_torch import Simulator\n"
        "from blades_tpu_torch.datasets import CIFAR10\n"
        "d = 'data/cifar-10-batches-py'\n"
        "os.makedirs(d)\n"
        "r = np.random.RandomState(0)\n"
        "for name in [f'data_batch_{i}' for i in range(1, 6)] + ['test_batch']:\n"
        "    with open(os.path.join(d, name), 'wb') as f:\n"
        "        pickle.dump({b'data': r.randint(0, 256, (12, 3072)).astype(np.uint8),\n"
        "                     b'labels': r.randint(0, 10, 12).tolist()}, f)\n"
        "def make():\n"
        "    return Simulator(CIFAR10(data_root='data', num_clients=4, cache=False),\n"
        "                     attack='alie', num_byzantine=1, aggregator='trimmedmean',\n"
        "                     aggregator_kws={'num_byzantine': 1}, device='cpu',\n"
        "                     log_path='out')\n"
        "def boom(rnd, state, m):\n"
        "    raise RuntimeError('kill')\n"
        "run = dict(model='cct_2_3x2_32', global_rounds=2, train_batch_size=2,\n"
        "           validate_interval=2)\n"
        "try:\n"
        "    make().run(on_round_end=boom, **run)\n"
        "except RuntimeError:\n"
        "    pass\n"
        "assert os.path.exists('out/autosave.npz')\n"
        "assert len(make().run(resume=True, **run)) == 1\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_forensics_modules_are_covered_and_a_traced_run_loads_no_jax(tmp_path):
    """``telemetry/`` and ``audit/`` are among the checked sources, and a run
    with the diagnostics, the audit monitor, the metric pack and a profiler
    capture leaves no ``jax`` in ``sys.modules``."""
    files = _port_files()
    pkg = ROOT / "blades_tpu_torch"
    for rel in ("telemetry/__init__.py", "telemetry/context.py", "telemetry/recorder.py",
                "telemetry/schema.py", "telemetry/metric_pack.py", "telemetry/profiling.py",
                "audit/__init__.py", "audit/monitor.py"):
        assert pkg / rel in files
    code = (
        "import sys\n"
        "from blades_tpu_torch import AuditMonitor, Simulator\n"
        "from blades_tpu_torch.datasets import Synthetic\n"
        "from blades_tpu_torch.telemetry.schema import validate_trace\n"
        "ds = Synthetic(num_clients=6, train_size=120, test_size=30, cache=False)\n"
        "sim = Simulator(ds, attack='alie', num_byzantine=2, aggregator='trimmedmean',\n"
        "                aggregator_kws={'num_byzantine': 1}, device='cpu', log_path='out')\n"
        "sim.run(model='mlp', global_rounds=2, train_batch_size=4, block_size=2,\n"
        "        collect_diagnostics=True, round_metrics=True, profile_dir='prof',\n"
        "        audit_monitor=AuditMonitor(fallback_aggregator='trimmedmean'))\n"
        "assert validate_trace('out/telemetry.jsonl') == []\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_baseline_models_are_covered_and_a_resnet_round_loads_no_jax(tmp_path):
    """``models/resnet.py``, ``models/wrn.py`` and the reference-path
    aliases are among the checked sources, and a ResNet-18 round (at
    MNIST's one-channel shape, K=2, one local step) leaves no ``jax`` in
    ``sys.modules``."""
    files = _port_files()
    pkg = ROOT / "blades_tpu_torch" / "models"
    for rel in ("resnet.py", "wrn.py", "cifar10.py", "mnist.py"):
        assert pkg / rel in files
    code = (
        "import sys\n"
        "from blades_tpu_torch import Simulator\n"
        "from blades_tpu_torch.datasets import Synthetic\n"
        "import blades_tpu_torch.models.cifar10, blades_tpu_torch.models.mnist\n"
        "ds = Synthetic(num_clients=2, train_size=8, test_size=4, cache=False)\n"
        "sim = Simulator(ds, aggregator='mean', device='cpu', log_path='out')\n"
        "sim.run(model='resnet18', global_rounds=1, train_batch_size=2)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_certification_and_run_record_modules_are_covered_and_load_no_jax(tmp_path):
    """The certification path (``audit/attack_search.py``,
    ``audit/contracts.py``, ``sweeps/``, ``examples/certify.py``) and the
    run's records (``telemetry/ledger.py``, ``alerts.py``, ``timeline.py``,
    ``supervision/``) are among the checked sources, and a quick
    certification plus a Simulator run with the ledger, alerts and the
    heartbeat on leave no ``jax`` in ``sys.modules``."""
    files = _port_files()
    pkg = ROOT / "blades_tpu_torch"
    for rel in ("audit/attack_search.py", "audit/contracts.py", "sweeps/__init__.py",
                "examples/certify.py", "telemetry/ledger.py", "telemetry/alerts.py",
                "telemetry/timeline.py", "supervision/__init__.py",
                "supervision/heartbeat.py"):
        assert pkg / rel in files
    code = (
        "import json, os, sys\n"
        "os.environ['BLADES_LEDGER'] = 'ledger.jsonl'\n"
        "os.environ['BLADES_HEARTBEAT_FILE'] = 'hb.json'\n"
        "from blades_tpu_torch import Simulator\n"
        "from blades_tpu_torch.datasets import Synthetic\n"
        "from blades_tpu_torch.examples import certify\n"
        "rc = certify.main(['--device', 'cpu', '--quick', '--clients', '6', '--dim', '8',\n"
        "                   '--trials', '1', '--aggs', 'mean', 'trimmedmean', 'dnc',\n"
        "                   '--out', 'cert'])\n"
        "assert rc == 0\n"
        "ds = Synthetic(num_clients=6, train_size=120, test_size=30, cache=False)\n"
        "sim = Simulator(ds, attack='alie', num_byzantine=2, aggregator='trimmedmean',\n"
        "                device='cpu', log_path='out')\n"
        "sim.run(model='mlp', global_rounds=2, train_batch_size=4)\n"
        "events = [json.loads(l)['event'] for l in open('ledger.jsonl')]\n"
        "assert events == ['started', 'finished'] * 2, events\n"
        "assert json.load(open('hb.json'))['round'] == 2\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_ports_outputs_never_name_the_jax_packages_committed_files(tmp_path,
                                                                      monkeypatch):
    """With ``BLADES_LEDGER`` set the port's ledger is that file, and the
    certify script's default output is its own directory: neither names
    ``results/certification/cert_matrix.json`` or the checkout's
    ``results/ledger.jsonl`` (and the ledger's default is another file)."""
    from blades_tpu_torch.examples import certify
    from blades_tpu_torch.telemetry import ledger

    committed = {(ROOT / "results" / "certification").resolve(),
                 (ROOT / "results" / "certification" / "cert_matrix.json").resolve(),
                 (ROOT / "results" / "ledger.jsonl").resolve()}
    monkeypatch.setenv(ledger.LEDGER_ENV, str(tmp_path / "ledger.jsonl"))
    assert Path(ledger.ledger_path()).resolve() == (tmp_path / "ledger.jsonl").resolve()
    out = Path(certify.parse_args([]).out).resolve()
    assert out not in committed and (out / "cert_matrix.json").resolve() not in committed
    assert out == (ROOT / "results" / "certification_torch").resolve()
    monkeypatch.delenv(ledger.LEDGER_ENV)
    monkeypatch.chdir(ROOT)
    assert Path(ledger.ledger_path()).resolve() not in committed


def test_resilient_and_supervision_modules_are_covered_and_a_supervised_certify_loads_no_jax(
        tmp_path):
    """The resilient sweeps (``sweeps/journal.py``, ``sweeps/resilient.py``,
    ``utils/retry.py``), the supervisor and its examples are among the
    checked sources; a supervised resilient certify, killed by the journal's
    saboteur and relaunched under ``BLADES_RESUME=1``, finishes with no
    ``jax`` in the supervisor's or either child's ``sys.modules``."""
    files = _port_files()
    pkg = ROOT / "blades_tpu_torch"
    for rel in ("sweeps/journal.py", "sweeps/resilient.py", "utils/retry.py",
                "supervision/supervisor.py", "supervision/__main__.py",
                "examples/chaos.py", "examples/supervised_run.py"):
        assert pkg / rel in files
    child = (
        "import sys\n"
        "from blades_tpu_torch.examples import certify\n"
        "rc = certify.main(['--device', 'cpu', '--quick', '--clients', '6', '--dim', '8',\n"
        "                   '--trials', '1', '--no-async', '--aggs', 'mean', 'trimmedmean',\n"
        "                   '--attempts', '2', '--out', 'cert'])\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('CHILD LEAKED', leaked)\n"
        "sys.exit(rc if not leaked else 3)\n"
    )
    code = (
        "import json, sys\n"
        "from blades_tpu_torch.supervision import Supervisor\n"
        f"result = Supervisor([sys.executable, '-c', {child!r}], attempts=2, base_delay_s=0.1,\n"
        "                    poll_s=0.1, telemetry_path='sup.jsonl', heartbeat_file='hb',\n"
        "                    env={'BLADES_SWEEP_KILL_AT': '3', 'BLADES_LEDGER': 'ledger.jsonl'}\n"
        "                    ).run()\n"
        "assert result.ok and result.attempts[0].returncode == -9, result\n"
        "assert json.load(open('cert/cert_matrix.json'))['resumed_skipped'] == 3\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_subprocess_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout and "CHILD LEAKED []" in proc.stdout


def test_service_modules_are_covered_and_a_served_simulate_loads_no_jax(tmp_path):
    """The service (``service/``, ``telemetry/reqpath.py``, the
    ``serve`` and ``service_client`` examples) is among the checked
    sources; a ``simulate`` and a ``certify`` sweep request served on the
    CPU by a ``SimulationService`` leave no ``jax`` in ``sys.modules``."""
    files = _port_files()
    pkg = ROOT / "blades_tpu_torch"
    for rel in ("service/__init__.py", "service/protocol.py", "service/spool.py",
                "service/client.py", "service/scheduler.py", "service/handlers.py",
                "service/server.py", "telemetry/reqpath.py", "examples/serve.py",
                "examples/service_client.py"):
        assert pkg / rel in files
    code = (
        "import sys\n"
        "from blades_tpu_torch.service.server import SimulationService\n"
        "svc = SimulationService('svc', device='cpu')\n"
        "sim = svc._execute('r1', {'kind': 'simulate', 'cells': [{'agg': 'trimmedmean',\n"
        "                   'agg_kws': {'num_byzantine': 1}, 'attack': 'alie', 'num_byz': 1,\n"
        "                   'rounds': 1}]})\n"
        "cert = svc._execute('r2', {'kind': 'sweep', 'sweep': 'certify', 'spec': {\n"
        "                    'quick': True, 'clients': 6, 'dim': 8, 'trials': 1,\n"
        "                    'no_async': True, 'aggs': ['mean']}})\n"
        "assert sim['ok'] and cert['ok'], (sim, cert)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LEAKED', leaked)\n"
        "assert not leaked, leaked\n"
    )
    env = _subprocess_env()
    env["BLADES_LEDGER"] = str(tmp_path / "ledger.jsonl")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
