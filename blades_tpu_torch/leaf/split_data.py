"""Train/test split of LEAF data (reference: ``models/utils/split_data.py``):
by-sample (per-user fraction, ``split_data.py:206``) or by-user (held-out
users, ``split_data.py:163``) split, preserving the LEAF JSON schema.

Counterpart: ``blades_tpu/leaf/split_data.py``, copied line for line (the
port imports nothing of the JAX package), so that Python's seeded
``random`` gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import argparse
import random

from blades_tpu_torch.leaf.util import read_leaf_dir, write_leaf_json


def split_leaf_by_user(data, frac: float = 0.9, seed: int = 0):
    """Held-out-user split: first ``frac`` of shuffled users train, rest test."""
    rng = random.Random(seed)
    users = list(data["users"])
    rng.shuffle(users)
    n_train = int(frac * len(users))
    sides = []
    for chosen in (users[:n_train], users[n_train:]):
        side = {"users": [], "num_samples": [], "user_data": {}}
        for u in chosen:
            side["users"].append(u)
            side["num_samples"].append(len(data["user_data"][u]["y"]))
            side["user_data"][u] = data["user_data"][u]
        sides.append(side)
    return tuple(sides)


def split_leaf(data, frac: float = 0.9, seed: int = 0):
    rng = random.Random(seed)
    train = {"users": [], "num_samples": [], "user_data": {}}
    test = {"users": [], "num_samples": [], "user_data": {}}
    for u in data["users"]:
        xs, ys = data["user_data"][u]["x"], data["user_data"][u]["y"]
        idx = list(range(len(ys)))
        rng.shuffle(idx)
        cut = max(1, int(frac * len(idx))) if len(idx) > 1 else len(idx)
        tr, te = idx[:cut], idx[cut:]
        for side, ids in ((train, tr), (test, te)):
            if not ids:
                continue
            side["users"].append(u)
            side["num_samples"].append(len(ids))
            side["user_data"][u] = {
                "x": [xs[i] for i in ids],
                "y": [ys[i] for i in ids],
            }
    return train, test


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--frac", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--by-user", action="store_true",
                   help="held-out-user split instead of per-user sample split")
    a = p.parse_args(argv)
    splitter = split_leaf_by_user if a.by_user else split_leaf
    train, test = splitter(read_leaf_dir(a.data_dir), a.frac, a.seed)
    write_leaf_json(train, f"{a.out_dir}/train/train.json")
    write_leaf_json(test, f"{a.out_dir}/test/test.json")
    print(
        f"train: {sum(train['num_samples'])} samples; "
        f"test: {sum(test['num_samples'])} samples"
    )


if __name__ == "__main__":
    main()
