"""The port's LEAF tools (``blades_tpu_torch/leaf/``) against the JAX
package's (``blades_tpu/leaf/``), on a LEAF directory the test writes:

- for seeds 0-9, each tool's output file (``sample`` IID and non-IID,
  ``split_data`` by sample and by user, ``remove_users``, the ``preprocess``
  pipeline's stage files and manifest) is byte-identical to the JAX tool's,
  and ``stats`` prints the same lines;
- ``preprocess --verify`` passes and fails as the JAX tool's does, with the
  same exit codes and lines;
- the offline gate and the Drive-form parse behave as in
  ``tests/test_leaf.py``;
- ``import blades_tpu_torch.leaf.preprocess`` (and the trace reader)
  leaves ``torch`` out of ``sys.modules``; ``python -m`` runs each tool.
"""

import contextlib
import io
import json
import os
import random
import subprocess
import sys
import zipfile

import pytest

from blades_tpu.leaf import preprocess as jax_preprocess
from blades_tpu.leaf import remove_users as jax_remove_users
from blades_tpu.leaf import sample as jax_sample
from blades_tpu.leaf import split_data as jax_split_data
from blades_tpu.leaf import stats as jax_stats
from blades_tpu.leaf.download import _parse_confirm_form as jax_parse_form
from blades_tpu_torch.leaf import preprocess, remove_users, sample, split_data, stats
from blades_tpu_torch.leaf.util import read_leaf_dir
from blades_tpu_torch.leaf.download import (
    _parse_confirm_form,
    download_and_extract,
    download_file_from_google_drive,
)
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(10)


def write_leaf_dir(path, users=30, seed=123):
    """A LEAF ``all_data`` directory in two files: ``users`` users with 2-40
    samples each, 4 floats and a class id per sample."""
    rng = random.Random(seed)
    path.mkdir(parents=True)
    names = [f"f_{i:04d}" for i in range(users)]
    for part, chunk in enumerate((names[: users // 2], names[users // 2:])):
        data = {"users": [], "num_samples": [], "user_data": {}}
        for u in chunk:
            n = rng.randint(2, 40)
            data["users"].append(u)
            data["num_samples"].append(n)
            data["user_data"][u] = {"x": [[rng.random() for _ in range(4)] for _ in range(n)],
                                    "y": [rng.randrange(62) for _ in range(n)]}
        with open(path / f"all_data_{part}.json", "w") as f:
            json.dump(data, f)
    return str(path)


@pytest.fixture(scope="module")
def leaf_dir(tmp_path_factory):
    return write_leaf_dir(tmp_path_factory.mktemp("leaf") / "all_data")


def _quiet(fn, *args):
    """``fn(*args)`` with its printed lines returned."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _tree(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


#: each tool's argv (after the data dir and its seed), by name: the port's
#: module, the JAX package's, and whether it writes a file or a directory
TOOLS = {
    "sample_niid": (sample, jax_sample, "file", ["--fraction", "0.3"]),
    "sample_iid": (sample, jax_sample, "file", ["--fraction", "0.5", "--iid"]),
    "split_sample": (split_data, jax_split_data, "dir", ["--frac", "0.7"]),
    "split_user": (split_data, jax_split_data, "dir", ["--frac", "0.6", "--by-user"]),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_tools_write_the_jax_tools_bytes(leaf_dir, tmp_path, tool, seed):
    ours, theirs, kind, extra = TOOLS[tool]
    written, printed = {}, {}
    for name, mod in (("port", ours), ("jax", theirs)):
        target = str(tmp_path / name / ("out.json" if kind == "file" else "out"))
        flag = "--out-file" if kind == "file" else "--out-dir"
        printed[name] = _quiet(mod.main, ["--data-dir", leaf_dir, flag, target,
                                          "--seed", str(seed), *extra])
        written[name] = _tree(str(tmp_path / name))
    assert written["port"] == written["jax"] and written["port"]
    assert printed["port"] == printed["jax"]


@pytest.mark.parametrize("seed", SEEDS)
def test_preprocess_pipeline_writes_the_jax_pipelines_bytes(leaf_dir, tmp_path, seed):
    """The niid sample -> remove users -> split pipeline at sample seed
    ``seed`` and split seed ``seed + 1`` (and, for even seeds, the IID
    sample into 5 users with the held-out-user split): every stage file
    and the manifest equal, the final stats printed equal."""
    argv = ["--data-dir", leaf_dir, "-s", "niid", "--sf", "0.4", "-k", "10", "-t", "sample",
            "--tf", "0.8", "--smplseed", str(seed), "--spltseed", str(seed + 1)]
    if seed % 2 == 0:
        argv = ["--data-dir", leaf_dir, "-s", "iid", "--sf", "0.5", "--iu", "5", "-t", "user",
                "--tf", "0.6", "--smplseed", str(seed), "--spltseed", str(seed + 1)]
    trees, printed = {}, {}
    for name, mod in (("port", preprocess), ("jax", jax_preprocess)):
        out = str(tmp_path / name)
        printed[name] = _quiet(mod.main, argv + ["--out-dir", out])
        trees[name] = _tree(out)
    assert trees["port"] == trees["jax"]
    assert printed["port"] == printed["jax"]
    manifest = json.loads(trees["port"][os.path.join("meta", "manifest.json")])
    assert sorted(manifest) == sorted(k for k in trees["port"] if k.endswith(".json")
                                      and not k.startswith("meta"))


def test_stats_prints_the_jax_tools_lines(leaf_dir):
    assert _quiet(stats.main, ["--data-dir", leaf_dir]) == _quiet(
        jax_stats.main, ["--data-dir", leaf_dir])
    data = read_leaf_dir(leaf_dir)
    assert stats.leaf_stats(data) == jax_stats.leaf_stats(data)


@pytest.mark.parametrize("min_samples", [1, 10, 25])
def test_remove_users_writes_the_jax_tools_bytes(leaf_dir, tmp_path, min_samples):
    files = {}
    for name, mod in (("port", remove_users), ("jax", jax_remove_users)):
        path = str(tmp_path / f"{name}.json")
        _quiet(mod.main, ["--data-dir", leaf_dir, "--out-file", path,
                          "--min-samples", str(min_samples)])
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"]


def _verify(mod, out_dir, manifest):
    """``main(["--verify", ...])``'s exit code and printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        mod.main(["--out-dir", out_dir, "--verify", manifest])
    return e.value.code, buf.getvalue()


def test_verify_passes_and_fails_as_the_jax_tool(leaf_dir, tmp_path):
    out = str(tmp_path / "out")
    _quiet(preprocess.main, ["--data-dir", leaf_dir, "--out-dir", out, "-s", "niid",
                             "--sf", "0.5", "-k", "5", "-t", "sample", "--smplseed", "1",
                             "--spltseed", "2"])
    manifest = os.path.join(out, "meta", "manifest.json")
    ok = [_verify(mod, out, manifest) for mod in (preprocess, jax_preprocess)]
    assert ok[0] == ok[1] and ok[0][0] == 0 and "Matching" in ok[0][1]
    with open(os.path.join(out, "train", "train.json"), "w") as f:
        f.write('{"users": []}')
    bad = [_verify(mod, out, manifest) for mod in (preprocess, jax_preprocess)]
    assert bad[0] == bad[1] and bad[0][0] == 1 and "differs: train" in bad[0][1]
    # an all-skipped rerun leaves the manifest (the record of what was
    # produced) as it was, as in JAX
    before = open(manifest, "rb").read()
    said = _quiet(preprocess.main, ["--data-dir", leaf_dir, "--out-dir", out, "-s", "niid",
                                    "--sf", "0.5", "-k", "5", "-t", "sample"])
    assert "already been generated" in said and open(manifest, "rb").read() == before


def test_download_offline_gate(tmp_path, monkeypatch):
    """The Drive fetcher refuses (not hangs) when offline, through the
    port's ``utils/fetch.py``, and uses an archive already in place without
    touching the network."""
    monkeypatch.setenv("BLADES_TPU_OFFLINE", "1")
    with pytest.raises(RuntimeError, match="BLADES_TPU_OFFLINE"):
        download_file_from_google_drive("fakeid", str(tmp_path / "x.zip"))
    archive = tmp_path / "dataset.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("all_data/data.json", '{"users": []}')
    assert download_and_extract("fakeid", str(tmp_path)) == str(tmp_path)
    assert (tmp_path / "all_data" / "data.json").exists() and not archive.exists()
    bad = tmp_path / "b"
    bad.mkdir()
    (bad / "dataset.zip").write_bytes(b"not a zip")
    with pytest.raises(RuntimeError, match="not a valid zip"):
        download_and_extract("fakeid", str(bad))
    assert not (bad / "dataset.zip").exists()


@pytest.mark.parametrize("html,expected", [
    ('''<html><body>
    <form id="download-form" action="https://drive.usercontent.google.com/download" method="get">
    <input type="hidden" name="id" value="FILEID">
    <input type="hidden" name="confirm" value="t">
    <input type="hidden" name="uuid" value="abc-123">
    </form></body></html>''',
     ("https://drive.usercontent.google.com/download",
      {"id": "FILEID", "confirm": "t", "uuid": "abc-123"})),
    ("<html>no form here</html>", None),
])
def test_drive_confirm_form_parsing_equals_the_jax_tool(html, expected):
    assert _parse_confirm_form(html) == jax_parse_form(html) == expected


def test_the_tools_and_readers_import_no_torch():
    code = ("import sys\n"
            "import blades_tpu_torch.leaf.preprocess, blades_tpu_torch.leaf.download\n"
            "import blades_tpu_torch.examples.trace_summary\n"
            "import blades_tpu_torch.examples.runs, blades_tpu_torch.examples.sweep_status\n"
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n"
            "assert 'jax' not in sys.modules and 'blades_tpu' not in sys.modules\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=60)


def test_python_m_runs_the_port_tool(leaf_dir, tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = str(tmp_path / "s.json")
    proc = subprocess.run([sys.executable, "-m", "blades_tpu_torch.leaf.sample", "--data-dir",
                           leaf_dir, "--out-file", out, "--fraction", "0.2", "--seed", "3"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    ref = str(tmp_path / "j.json")
    assert proc.stdout == _quiet(jax_sample.main, ["--data-dir", leaf_dir, "--out-file", ref,
                                                   "--fraction", "0.2", "--seed", "3"])
    assert open(out, "rb").read() == open(ref, "rb").read()
