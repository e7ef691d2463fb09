"""The port's static-analysis gate (``blades_tpu_torch/analysis``): both
directions of every Tier-A rule (each fires on its fixture mini-repo under
``tests/fixtures/analysis_torch/<ruleid>/`` and the full set is silent on
the port's tree), the pragma and baseline waivers, the CLI's one-JSON-line
contract, Tier B's round-program audit on the CPU (and on the card, marked
``cuda``), and parity with the JAX package's analysis on the same fixture
trees."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from blades_tpu_torch.analysis import RepoIndex, Rule, Violation, all_rules, run_rules
from blades_tpu_torch.analysis import core as port_core
from blades_tpu_torch.analysis.program_audit import CHECKS, PROGRAMS, run_tier_b
from blades_tpu_torch.core import RoundEngine
from blades_tpu_torch.telemetry.recorder import count_process
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis_torch")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")

RULE_IDS = [
    "ALIAS001", "XLA001", "IMP001", "IMP002", "SYNC001",
    "PAL001", "TEL001", "JSON001", "CITE001", "SCHEMA001",
]

DOC = '"""Doc. Reference counterpart: none — test module."""\n'


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def _cli(*argv, module="blades_tpu_torch.analysis"):
    return subprocess.run([sys.executable, "-m", module, *argv], capture_output=True,
                          text=True, env=_env(), cwd=REPO, timeout=300)


def _tree(tmp_path, files: dict) -> str:
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(tmp_path)


def _run(root: str):
    return run_rules(RepoIndex(root), all_rules())


@pytest.fixture(scope="module")
def head():
    """The full rule set over the port's tree (one parse for the module)."""
    return _run(REPO)


# -- Tier A: rule-set health -----------------------------------------------------


def test_registry_has_the_ten_jax_rule_ids():
    from blades_tpu.analysis import all_rules as jax_rules

    rules = all_rules()
    ids = [r.id for r in rules]
    assert ids == RULE_IDS == [r.id for r in jax_rules()]
    for r in rules:
        assert r.rationale and r.severity in ("error", "warning"), r.id


def test_tier_a_silent_on_the_port(head):
    """No unwaived violation on the port's tree; the waivers are exactly the
    host stopping rules of GeoMed and AutoGM (ROADMAP.md queue B, 7c)."""
    violations, waived = head
    assert violations == [], "\n".join(str(v) for v in violations)
    assert sorted((v.rule, v.path) for v in waived) == [
        ("SYNC001", "blades_tpu_torch/aggregators/autogm.py"),
        ("SYNC001", "blades_tpu_torch/aggregators/geomed.py"),
    ]
    for v in waived:
        src = open(os.path.join(REPO, v.path)).read().splitlines()
        assert "7c" in src[v.line - 2], src[v.line - 2]


def test_the_index_walks_the_port_and_its_scripts_only():
    index = RepoIndex(REPO)
    rels = {m.rel for m in index.files}
    assert {"chip_smoke.py", "kernel_stages.py",
            "blades_tpu_torch/analysis/core.py"} <= rels
    assert not any(r.startswith(("blades_tpu/", "tests/", "scripts/")) for r in rels)


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_each_rule_fires_on_its_fixture(rule_id):
    root = os.path.join(FIXTURES, rule_id.lower())
    assert os.path.isdir(root), f"missing fixture tree {root}"
    violations, _ = _run(root)
    assert [v.rule for v in violations] == [rule_id], [str(v) for v in violations]
    v = violations[0]
    src = open(os.path.join(root, v.path)).read().splitlines()
    window = "\n".join(src[max(0, v.line - 3): v.line + 2])
    assert "VIOLATION" in window, f"{rule_id} fired at {v.path}:{v.line}:\n{window}"


def test_pragma_waives_and_is_counted(tmp_path):
    root = _tree(tmp_path, {"blades_tpu_torch/launch.py": DOC + (
        "import torch\n"
        "torch.backends.cudnn.benchmark = True  # blades: allow[XLA001] fixture\n"
        "# a justification above the line  # blades: allow[XLA001]\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "torch.backends.cudnn.deterministic = True\n")})
    violations, waived = _run(root)
    assert [(v.rule, v.line) for v in waived] == [("XLA001", 3), ("XLA001", 5)]
    assert [(v.rule, v.line) for v in violations] == [("XLA001", 6)]


def test_unparseable_file_fails_the_gate(tmp_path):
    root = _tree(tmp_path, {"blades_tpu_torch/broken.py": "def f(:\n"})
    violations, _ = _run(root)
    assert [v.rule for v in violations] == ["PARSE000"]


# -- Tier A: the port's rules, clause by clause --------------------------------------


def test_sync001_roots_and_flow(tmp_path):
    """Roots: a function handed to vmap (through a module-level binding),
    a lambda, the body of a ``torch.cuda.graph`` block, the attack's
    ``on_grads``; a host ``int`` read before the name becomes a tensor is
    legal; ``.shape`` reads are metadata."""
    root = _tree(tmp_path, {"blades_tpu_torch/core/engine.py": DOC + textwrap.dedent('''\
        import time
        import torch
        from torch.func import vmap


        def step(x):
            return x * x.sum().item()


        fn = step


        def run(x, g):
            y = vmap(fn)(x)
            z = vmap(lambda r: r * float(r.max()))(x)
            with torch.cuda.graph(g):
                body(x)
            return y, z


        def body(x):
            torch.cuda.synchronize()
            return x


        def on_grads(grads, byz, client_idx=None):
            n = int(grads.shape[0])
            k = grads.numel()
            idx = torch.full((), int(k))
            if idx > 3:
                time.sleep(0)
            return grads


        def offline(x):
            return x.cpu().numpy()
        ''')})
    violations, _ = _run(root)
    got = sorted((v.line, v.message.split(" in ")[0]) for v in violations)
    assert [v.rule for v in violations] == ["SYNC001"] * 5, [str(v) for v in violations]
    assert got == [
        (8, "`.item()`"),
        (16, "float(<tensor>)"),
        (23, "torch.cuda.synchronize()"),
        (31, "Python `if` on a tensor"),
        (32, "time.sleep()"),
    ], got


@pytest.mark.parametrize("case", ["no_plain", "no_counter", "plain_off_cpu", "unloaded_cu"])
def test_pal001_clauses(tmp_path, case):
    kernel = textwrap.dedent('''\
        import functools
        import torch
        from blades_tpu_torch.ops import _build

        col_launches = 0


        @functools.lru_cache(maxsize=None)
        def _library():
            return _build.load("col")


        def col_plain(x):
            return x.sum(dim=0)


        def col_cuda(x):
            global col_launches
            out = torch.empty(x.shape[1], device=x.device)
            _library().col(x.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            col_launches += 1
            return out


        def col(x):
            if x.device.type == "cuda":
                return col_cuda(x)
            if x.device.type == "cpu":
                return col_plain(x)
            raise ValueError(x.device)
        ''')
    edits = {
        "no_plain": ("col_plain", "col_reference"),
        "no_counter": ("    col_launches += 1\n", ""),
        "plain_off_cpu": ("    raise ValueError(x.device)", "    return col_plain(x)"),
        "unloaded_cu": ("", ""),
    }
    old, new = edits[case]
    src = kernel.replace(old, new) if old else kernel
    files = {"blades_tpu_torch/ops/col.py": DOC + src,
             "blades_tpu_torch/csrc/col.cu": "// col\n"}
    if case == "unloaded_cu":
        files["blades_tpu_torch/csrc/other.cu"] = "// other\n"
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    violations, _ = _run(str(tmp_path))
    assert [v.rule for v in violations] == ["PAL001"], [str(v) for v in violations]
    expect = {"no_plain": "no plain version", "no_counter": "no module-level",
              "plain_off_cpu": "outside an `if", "unloaded_cu": "other.cu"}[case]
    assert expect in violations[0].message, violations[0].message


def test_pal001_holds_on_the_kernel_module_as_it_stands():
    """The port's one kernel module passes every clause: a plain version
    of each entry, a counter in each launch, no fallback, the plain
    version only on the CPU, every ``csrc/*.cu`` loaded."""
    from blades_tpu_torch.analysis.rules.pallas import Pal001

    assert Pal001().check(RepoIndex(REPO, roots=("blades_tpu_torch/ops",))) == []


def test_json001_binds_the_ports_contract_scripts(tmp_path):
    from blades_tpu_torch.analysis.rules.json_contract import CONTRACT_SCRIPTS

    assert set(CONTRACT_SCRIPTS) == {"blades_tpu_torch/examples/certify.py",
                                     "blades_tpu_torch/examples/runs.py",
                                     "blades_tpu_torch/examples/serve.py",
                                     "blades_tpu_torch/examples/sweep_status.py",
                                     "blades_tpu_torch/analysis/__main__.py"}
    for rel in CONTRACT_SCRIPTS:
        assert os.path.isfile(os.path.join(REPO, rel))
    src = open(os.path.join(FIXTURES, "json001/blades_tpu_torch/examples/certify.py")).read()
    root = _tree(tmp_path, {"blades_tpu_torch/examples/serve.py": src})
    assert [v.rule for v in _run(root)[0]] == ["JSON001"]


def test_imp001_follows_torch_through_the_ports_own_modules(tmp_path):
    """A contracted file importing a port module that imports torch (here
    through its package's ``__init__``) breaks the contract as surely as
    ``import torch``; a function-scope import stays legal."""
    root = _tree(tmp_path, {
        "blades_tpu_torch/ops/__init__.py": DOC + "import torch\n",
        "blades_tpu_torch/ops/pytree.py": DOC,
        "blades_tpu_torch/sweeps/journal.py": DOC + "from blades_tpu_torch.ops.pytree import x\n",
        "blades_tpu_torch/sweeps/resilient.py": DOC + (
            "def f():\n    import torch\n    return torch\n"),
    })
    violations, _ = _run(root)
    assert [(v.rule, v.path) for v in violations] == [
        ("IMP001", "blades_tpu_torch/sweeps/journal.py")]
    assert "blades_tpu_torch.ops" in violations[0].message


def test_alias001_accepts_copies_and_flags_views(tmp_path):
    root = _tree(tmp_path, {"blades_tpu_torch/restore.py": DOC + textwrap.dedent('''\
        import numpy as np
        import torch


        def restore(path):
            z = np.load(path)
            a = torch.from_numpy(np.array(z["a"], copy=True))
            b = torch.from_numpy(z["b"].copy())
            c = torch.from_numpy(z["c"]).clone()
            d = torch.tensor(z["d"])
            e = torch.as_tensor(z["e"])
            return a, b, c, d, e
        ''')})
    violations, _ = _run(root)
    assert [(v.rule, v.line) for v in violations] == [("ALIAS001", 12)]


def test_xla001_catches_every_spelling_and_spares_the_owner(tmp_path):
    body = textwrap.dedent('''\
        import torch
        from torch import backends


        def f():
            torch.backends.cuda.matmul.allow_tf32 = True
            backends.cudnn.deterministic = False
            setattr(torch.backends.cudnn, "benchmark", True)
            torch.set_float32_matmul_precision("high")
            torch.use_deterministic_algorithms(True)
            return torch.backends.cudnn.deterministic
        ''')
    root = _tree(tmp_path, {"blades_tpu_torch/a.py": DOC + body,
                            "blades_tpu_torch/utils/platform.py": DOC + body})
    violations, _ = _run(root)
    assert [(v.rule, v.path, v.line) for v in violations] == [
        ("XLA001", "blades_tpu_torch/a.py", n) for n in (7, 8, 9, 10, 11)]


def test_numerics_scope_restores_the_switches():
    """``utils/platform.py``'s scoped form, the route ``chip_smoke.py``
    takes: the switches named are set inside and put back after."""
    from blades_tpu_torch.utils.platform import numerics, numerics_scope, set_numerics

    before = numerics()
    with numerics_scope(cudnn_deterministic=not before["cudnn_deterministic"]):
        assert numerics()["cudnn_deterministic"] is (not before["cudnn_deterministic"])
        assert {k: v for k, v in numerics().items() if k != "cudnn_deterministic"} == {
            k: v for k, v in before.items() if k != "cudnn_deterministic"}
    assert numerics() == before
    with pytest.raises(TypeError):
        set_numerics(tf32=False)


# -- the CLI -------------------------------------------------------------------------


def test_cli_tier_a_is_one_json_line_and_loads_no_torch():
    code = ("import runpy, sys\n"
            "sys.argv = ['analysis', '--check', '--tier', 'a']\n"
            "try:\n"
            "    runpy.run_module('blades_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('EXIT', e.code, 'TORCH', 'torch' in sys.modules, file=sys.stderr)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout + proc.stderr
    out = json.loads(lines[0])
    assert out["ok"] is True and out["violations"] == 0 and out["waived_pragma"] == 2
    assert out["rules"] == {r: 0 for r in RULE_IDS}
    assert "EXIT 0 TORCH False" in proc.stderr, proc.stderr


def test_cli_failure_is_still_one_json_line(tmp_path):
    proc = _cli("--check", "--tier", "a", "--root", os.path.join(FIXTURES, "pal001"))
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 1 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] is False and out["rules"]["PAL001"] == 1
    bad = tmp_path / "baseline.json"
    bad.write_text("{not json")
    proc = _cli("--check", "--tier", "a", "--baseline", str(bad))
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 1 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] is False and "JSONDecodeError" in out["error"]


def test_cli_baseline_waives_and_round_trips(tmp_path):
    root = os.path.join(FIXTURES, "tel001")
    base = tmp_path / "baseline.json"
    proc = _cli("--check", "--tier", "a", "--root", root, "--baseline", str(base),
                "--write-baseline")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(base.read_text()) == {
        "waivers": ["TEL001:blades_tpu_torch/telemetry/recorder.py"]}
    proc = _cli("--check", "--tier", "a", "--root", root, "--baseline", str(base))
    out = json.loads(proc.stdout)
    assert proc.returncode == 0 and out["ok"] and out["waived_baseline"] == 1


def test_cli_keys_equal_the_jax_clis():
    """``--tier a`` on the same fixture tree: the port's line has the JAX
    line's keys (each tier stdlib-only, so both run here in seconds)."""
    port = _cli("--check", "--tier", "a", "--root", os.path.join(FIXTURES, "tel001"))
    jax = _cli("--check", "--tier", "a", "--root", os.path.join(JAX_FIXTURES, "tel001"),
               module="blades_tpu.analysis")
    p, j = json.loads(port.stdout), json.loads(jax.stdout)
    assert set(p) == set(j) and set(p["rules"]) == set(j["rules"])
    assert (p["ok"], p["violations"], p["rules"]["TEL001"]) == (
        j["ok"], j["violations"], j["rules"]["TEL001"]) == (False, 1, 1)


# -- parity with the JAX package's analysis -------------------------------------------


def _trivial(base):
    """One rule written for both engines: every ``print`` call."""
    import ast

    class Print(base):
        id = "PRINT000"
        rationale = "fixture"

        def check(self, index):
            out = []
            for mod in index.files:
                if mod.tree is None:
                    continue
                for node in ast.walk(mod.tree):
                    if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print":
                        out.append(self.violation(mod, node, "print"))
            return out

    return Print()


def test_core_agrees_with_the_jax_core(tmp_path):
    from blades_tpu.analysis import core as jax_core

    root = _tree(tmp_path, {
        "blades_tpu_torch/a.py": DOC + (
            "print(1)  # blades: allow[PRINT000]\n"
            "# above  # blades: allow[*]\n"
            "print(2)\n"
            "print(3)\n"),
        "blades_tpu/b.py": "print(4)  # blades: allow[OTHER001, PRINT000]\n",
        "blades_tpu_torch/c.py": "def f(:\n",
    })
    roots = ("blades_tpu_torch", "blades_tpu", "bench.py")
    for tree in (root, *(os.path.join(JAX_FIXTURES, d) for d in sorted(os.listdir(JAX_FIXTURES))
                         if os.path.isdir(os.path.join(JAX_FIXTURES, d)))):
        jv, jw = jax_core.run_rules(jax_core.RepoIndex(tree, roots), [_trivial(jax_core.Rule)])
        pv, pw = port_core.run_rules(port_core.RepoIndex(tree, roots),
                                     [_trivial(port_core.Rule)])
        key = lambda vs: [(v.rule, v.path, v.line, v.message.split(": ")[0]) for v in vs]  # noqa: E731
        assert key(pv) == key(jv) and key(pw) == key(jw), tree
    pv, pw = port_core.run_rules(port_core.RepoIndex(root, roots), [_trivial(port_core.Rule)])
    assert [(v.path, v.line) for v in pw] == [("blades_tpu/b.py", 1),
                                              ("blades_tpu_torch/a.py", 2),
                                              ("blades_tpu_torch/a.py", 4)]
    assert [(v.rule, v.path) for v in pv] == [("PRINT000", "blades_tpu_torch/a.py"),
                                              ("PARSE000", "blades_tpu_torch/c.py")]
    assert isinstance(pv[0], Violation) and issubclass(type(_trivial(Rule)), Rule)


@pytest.mark.parametrize("rule_id,jax_rel,port_rel", [
    ("CITE001", "blades_tpu/bare.py", "blades_tpu_torch/bare.py"),
    ("JSON001", "bench.py", "blades_tpu_torch/examples/certify.py"),
    ("TEL001", "blades_tpu/telemetry/recorder.py", "blades_tpu_torch/telemetry/recorder.py"),
])
def test_rules_agree_with_jax_on_its_fixtures(tmp_path, rule_id, jax_rel, port_rel):
    """The JAX fixture of the rule, copied to the port's path: both rules
    report it on the same line (CITE001 and JSON001 with the same
    message)."""
    from blades_tpu.analysis import RepoIndex as JaxIndex
    from blades_tpu.analysis import all_rules as jax_rules

    src = os.path.join(JAX_FIXTURES, rule_id.lower())
    dst = tmp_path / port_rel
    dst.parent.mkdir(parents=True)
    shutil.copy(os.path.join(src, jax_rel), dst)
    jrule = next(r for r in jax_rules() if r.id == rule_id)
    prule = next(r for r in all_rules() if r.id == rule_id)
    jv, pv = jrule.check(JaxIndex(src)), prule.check(RepoIndex(str(tmp_path)))
    assert [(v.rule, v.line) for v in pv] == [(v.rule, v.line) for v in jv] and len(pv) == 1
    assert pv[0].path == port_rel
    if rule_id != "TEL001":
        assert pv[0].message == jv[0].message


def test_tier_b_report_shape_equals_jaxs():
    """The report's keys and each check's keys are the JAX auditor's
    (read from its source: running it compiles the JAX programs)."""
    import ast
    import inspect

    from blades_tpu.analysis import program_audit as jax_audit

    assert set(jax_audit._result("c", "p", True, "d")) == {"check", "program", "ok", "detail"}
    fn = ast.parse(textwrap.dedent(inspect.getsource(jax_audit.run_tier_b)))
    ret = [n.value for n in ast.walk(fn)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(ret) == 1
    jax_keys = {k.value for k in ret[0].keys}
    port = run_tier_b("cpu", programs=["round"])
    assert set(port) == jax_keys
    assert all(set(c) == {"check", "program", "ok", "detail"} for c in port["checks"])


# -- Tier B on the CPU -------------------------------------------------------------------


@pytest.fixture(scope="module")
def tier_b_cpu():
    return run_tier_b("cpu")


def test_tier_b_covers_every_program_and_check(tier_b_cpu):
    got = {(c["program"], c["check"]): c for c in tier_b_cpu["checks"]}
    assert set(got) == {(p, c) for p in PROGRAMS for c in CHECKS}
    assert tier_b_cpu["programs"] == sorted(PROGRAMS)
    assert tier_b_cpu["ok"] is True and tier_b_cpu["violations"] == 0, [
        c for c in tier_b_cpu["checks"] if c["ok"] is False]
    for (program, check), c in got.items():
        assert c["ok"] is True, c
        if check == "sharding_axis":
            # the sharded program on a virtual (2, 4) mesh equals the
            # unsharded one (slice 12)
            assert c["detail"].startswith("virtual (2, 4) mesh"), c
    # the eager programs that take a batch list hand it over
    for program in ("round", "streaming", "async"):
        assert "emptied by run_round_donated" in got[(program, "storage")]["detail"]
    # the metrics' float64 host pack is outside the window, and reported
    assert "outputs_to_host" in got[("round", "dtype")]["detail"]


class CopiesState(RoundEngine):
    """A fixture engine that replaces the state's params with copies."""

    def _round(self, state, batch, inputs, streams):
        for name in list(state.params):
            state.params[name] = state.params[name].clone()
        return super()._round(state, batch, inputs, streams)


class EmitsFloat64(RoundEngine):
    """A fixture engine whose metric goes through a float64 temporary."""

    def _metrics(self, losses, top1s, var, agg):
        m = super()._metrics(losses, top1s, var, agg)
        return m._replace(agg_norm=torch.linalg.vector_norm(agg.double()).float())


class RebuildsEveryCall(RoundEngine):
    """A fixture engine that counts a capture on every call, as one that
    dropped its graph each time would."""

    def _round(self, state, batch, inputs, streams):
        count_process("cuda.graph_captures")
        return super()._round(state, batch, inputs, streams)


@pytest.mark.parametrize("engine_cls,check", [(CopiesState, "storage"),
                                              (EmitsFloat64, "dtype"),
                                              (RebuildsEveryCall, "rebuild_stability")],
                         ids=["copies-state", "emits-float64", "rebuilds"])
def test_tier_b_fails_on_fixture_engines(engine_cls, check):
    report = run_tier_b("cpu", engine_cls=engine_cls, programs=["round", "block"])
    assert report["ok"] is False
    failed = {(c["program"], c["check"]) for c in report["checks"] if c["ok"] is False}
    assert failed == {("round", check), ("block", check)}, report["checks"]


def test_tier_b_graph_storage_on_a_rehearsed_capture(monkeypatch):
    """The block's graph form, its capture rehearsed in Python on the CPU
    (the fakes of ``tests/test_torch_blocks.py::graph_device``): the
    graph's static state keeps its storage from block to block; an engine
    that copies the state moves it."""
    import contextlib

    from blades_tpu_torch.core import graphs

    class NoStream:
        def __init__(self, *a, **kw):
            pass

        def wait_stream(self, other):
            pass

    class Replay:
        def __init__(self, graph, eng):
            self.graph, self.eng = graph, eng

        def replay(self):
            self.graph.out_vecs = self.graph.packer.pack(self.graph._body(self.eng))

    def capture(self, eng):
        self.graph, self.kernel_launches, self.capture_seconds = Replay(self, eng), 0, 0.0

    real_reason = RoundEngine.graph_block_reason

    def reason(self):
        device, self.device = self.device, torch.device("cuda")
        try:
            return real_reason(self)
        finally:
            self.device = device

    for name, value in (("Stream", NoStream), ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda *a: NoStream()),
                        ("synchronize", lambda *a: None), ("empty_cache", lambda: None),
                        ("is_available", lambda: True)):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    monkeypatch.setattr(graphs.RoundGraph, "_capture", capture)
    monkeypatch.setattr(RoundEngine, "graph_block_reason", reason)

    good = {c["check"]: c for c in run_tier_b("cpu", programs=["block"])["checks"]}
    assert good["storage"]["ok"] is True, good["storage"]
    assert "graph state on the same storage" in good["storage"]["detail"]
    bad = {c["check"]: c for c in run_tier_b("cpu", engine_cls=CopiesState,
                                              programs=["block"])["checks"]}
    assert bad["storage"]["ok"] is False
    assert "moved to new storage" in bad["storage"]["detail"], bad["storage"]


@pytest.mark.cuda
def test_tier_b_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from blades_tpu_torch.ops import trimmed

    before = trimmed.trimmed_mean_launches
    report = run_tier_b("cuda")
    assert report["ok"] is True, [c for c in report["checks"] if c["ok"] is False]
    got = {(c["program"], c["check"]): c for c in report["checks"]}
    for program in ("block", "experiment_batch_map", "experiment_batch_vmap"):
        assert "graph state on the same storage" in got[(program, "storage")]["detail"]
    assert trimmed.trimmed_mean_launches > before
