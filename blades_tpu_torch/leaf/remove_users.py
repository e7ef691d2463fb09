"""Prune users with too few samples (reference:
``models/utils/remove_users.py``).

Counterpart: ``blades_tpu/leaf/remove_users.py``, copied line for line
(the port imports nothing of the JAX package), so that Python's seeded
``random`` gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import argparse

from blades_tpu_torch.leaf.util import read_leaf_dir, write_leaf_json


def remove_small_users(data, min_samples: int = 10):
    keep = [i for i, n in enumerate(data["num_samples"]) if n >= min_samples]
    users = [data["users"][i] for i in keep]
    return {
        "users": users,
        "num_samples": [data["num_samples"][i] for i in keep],
        "user_data": {u: data["user_data"][u] for u in users},
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-file", required=True)
    p.add_argument("--min-samples", type=int, default=10)
    a = p.parse_args(argv)
    data = read_leaf_dir(a.data_dir)
    out = remove_small_users(data, a.min_samples)
    write_leaf_json(out, a.out_file)
    print(f"kept {len(out['users'])}/{len(data['users'])} users")


if __name__ == "__main__":
    main()
