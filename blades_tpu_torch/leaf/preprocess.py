"""LEAF preprocessing pipeline driver.

Reference: ``src/blades/models/utils/preprocess.sh`` (255 lines of bash
chaining ``sample.py`` → ``remove_users.py`` → ``split_data.py`` per
dataset with stage-skip idempotency, an MD5 manifest of every produced
JSON, and a ``--verify`` mode that diffs a directory against a saved
manifest). Re-implemented as one importable function + CLI with the same
stages and flags:

    python -m blades_tpu_torch.leaf.preprocess --data-dir D/all_data --out-dir D \
        -s niid --sf 0.1 -k 10 -t sample --tf 0.9 --smplseed 1 --spltseed 2
    python -m blades_tpu_torch.leaf.preprocess --out-dir D --verify D/meta/manifest.json

Stage outputs mirror the reference layout under ``--out-dir``:
``sampled_data/``, ``rem_user_data/``, ``train/``, ``test/``, and
``meta/manifest.json`` (JSON {relpath: md5} instead of an ``md5sum`` text
file — same role, structured). A stage whose output dir already holds
JSON is skipped, like the bash version.

Counterpart: ``blades_tpu/leaf/preprocess.py``, copied line for line (the
port imports nothing of the JAX package), so that Python's seeded
``random`` gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

from blades_tpu_torch.leaf.remove_users import remove_small_users
from blades_tpu_torch.leaf.sample import sample_leaf
from blades_tpu_torch.leaf.split_data import split_leaf, split_leaf_by_user
from blades_tpu_torch.leaf.stats import leaf_stats
from blades_tpu_torch.leaf.util import read_leaf_dir, write_leaf_json


def _has_json(d: str) -> bool:
    return os.path.isdir(d) and any(f.endswith(".json") for f in os.listdir(d))


_STAGE_DIRS = ("sampled_data", "rem_user_data", "train", "test")


def _manifest(out_dir: str) -> dict:
    """Digest of every produced JSON, keyed by out_dir-relative path.

    Walks only the pipeline's own stage directories — raw inputs that
    happen to live under ``out_dir`` (e.g. ``all_data/``) are not part of
    the produced artifact and must not affect verification.
    """
    digest = {}
    for stage in _STAGE_DIRS:
        stage_dir = os.path.join(out_dir, stage)
        for root, _, files in os.walk(stage_dir):
            for f in sorted(files):
                if not f.endswith(".json"):
                    continue
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    digest[os.path.relpath(path, out_dir)] = hashlib.md5(
                        fh.read()
                    ).hexdigest()
    return digest


def verify(out_dir: str, manifest_path: str) -> bool:
    """Reference ``--verify`` mode: diff current JSONs against a manifest."""
    with open(manifest_path) as f:
        expect = json.load(f)
    got = _manifest(out_dir)
    ok = expect == got
    if ok:
        print("Matching JSON files and checksums found!")
    else:
        for k in sorted(set(expect) | set(got)):
            if expect.get(k) != got.get(k):
                print(f"differs: {k}: {expect.get(k)} != {got.get(k)}")
        print("Differing checksums found - please verify")
    return ok


def preprocess(
    data_dir: str,
    out_dir: str,
    sample: str = "na",
    sample_frac: float | None = None,
    iid_users: int | None = None,
    min_samples: int | str = "na",
    train: str = "na",
    train_frac: float = 0.9,
    sample_seed: int = 0,
    split_seed: int = 0,
    checksum: bool = True,
) -> dict:
    """Run the sample → remove-users → split pipeline; returns final stats.

    ``sample`` ∈ {"na", "iid", "niid"}; ``train`` ∈ {"na", "user",
    "sample"} — the reference's ``-s`` / ``-t`` tags, including "na" for
    "skip this stage".
    """
    data = read_leaf_dir(data_dir)
    skipped = []
    ran = []

    if sample != "na":
        stage_dir = os.path.join(out_dir, "sampled_data")
        if _has_json(stage_dir):
            data = read_leaf_dir(stage_dir)
            skipped.append("sample")
        else:
            ran.append("sample")
            data = sample_leaf(
                data,
                fraction=sample_frac if sample_frac is not None else 0.1,
                iid=(sample == "iid"),
                # pass the requested --iu count through exactly; the
                # frac-and-back round trip truncates under float error
                iid_num_users=iid_users if iid_users else None,
                seed=sample_seed,
            )
            write_leaf_json(data, os.path.join(stage_dir, "sampled.json"))

    if min_samples != "na":
        stage_dir = os.path.join(out_dir, "rem_user_data")
        if _has_json(stage_dir):
            data = read_leaf_dir(stage_dir)
            skipped.append("remove_users")
        else:
            ran.append("remove_users")
            data = remove_small_users(data, int(min_samples))
            write_leaf_json(data, os.path.join(stage_dir, "pruned.json"))

    if train != "na":
        train_dir = os.path.join(out_dir, "train")
        test_dir = os.path.join(out_dir, "test")
        # both halves must exist to skip: a run killed between the two
        # writes would otherwise leave test/ permanently missing
        if _has_json(train_dir) and _has_json(test_dir):
            skipped.append("split")
        else:
            ran.append("split")
            splitter = split_leaf_by_user if train == "user" else split_leaf
            tr, te = splitter(data, train_frac, split_seed)
            write_leaf_json(tr, os.path.join(train_dir, "train.json"))
            write_leaf_json(te, os.path.join(test_dir, "test.json"))

    manifest_path = os.path.join(out_dir, "meta", "manifest.json")
    if checksum and (ran or not os.path.exists(manifest_path)):
        # never refresh the manifest on an all-skipped rerun: it is the
        # tamper-evidence record of what the pipeline PRODUCED, and
        # re-digesting untouched (possibly corrupted) files would defeat
        # the --verify mode
        os.makedirs(os.path.dirname(manifest_path), exist_ok=True)
        with open(manifest_path, "w") as f:
            json.dump(_manifest(out_dir), f, indent=2, sort_keys=True)

    stats = leaf_stats(data)
    if skipped:
        print(
            "Data for one of the specified preprocessing tasks has already "
            f"been generated (skipped: {', '.join(skipped)}); delete the "
            "stage directory to re-generate."
        )
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", help="all_data-format LEAF JSON dir")
    p.add_argument("--out-dir", required=True)
    p.add_argument("-s", "--sample", choices=["na", "iid", "niid"], default="na")
    p.add_argument("--sf", type=float, default=None,
                   help="fraction of data to sample")
    p.add_argument("--iu", type=int, default=None,
                   help="number of users if iid sampling")
    p.add_argument("-k", "--min-samples", default="na",
                   help="minimum samples per user ('na' skips)")
    p.add_argument("-t", "--train", choices=["na", "user", "sample"],
                   default="na")
    p.add_argument("--tf", type=float, default=0.9,
                   help="fraction of data in training set")
    p.add_argument("--smplseed", type=int, default=0)
    p.add_argument("--spltseed", type=int, default=0)
    p.add_argument("--nochecksum", action="store_true")
    p.add_argument("--verify", metavar="MANIFEST",
                   help="verify out-dir against a saved manifest and exit")
    a = p.parse_args(argv)

    if a.verify:
        sys.exit(0 if verify(a.out_dir, a.verify) else 1)
    if not a.data_dir:
        p.error("--data-dir is required unless --verify is given")
    stats = preprocess(
        a.data_dir, a.out_dir, sample=a.sample, sample_frac=a.sf,
        iid_users=a.iu, min_samples=a.min_samples, train=a.train,
        train_frac=a.tf, sample_seed=a.smplseed, split_seed=a.spltseed,
        checksum=not a.nochecksum,
    )
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
