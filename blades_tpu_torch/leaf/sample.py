"""Sample users/datapoints from LEAF raw data (reference:
``models/utils/sample.py``): IID mode pools all datapoints and deals them to
synthetic users; non-IID mode picks random users until the requested fraction
of datapoints is covered.

Counterpart: ``blades_tpu/leaf/sample.py``, copied line for line (the port
imports nothing of the JAX package), so that Python's seeded ``random``
gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import argparse
import random

from blades_tpu_torch.leaf.util import iid_divide, read_leaf_dir, write_leaf_json


def sample_leaf(
    data,
    fraction: float,
    iid: bool,
    iid_user_frac: float = 0.01,
    seed: int = 0,
    iid_num_users: int = None,
):
    """``iid_num_users`` passes the synthetic-user count through exactly;
    ``iid_user_frac`` (kept for reference CLI parity) derives it from the
    original population via the reference's ``int(round(frac * len))``
    (floor 1) — rounding, so fractions that are exact user counts
    round-trip (3/147 of 147 users -> 3)."""
    rng = random.Random(seed)
    tot = sum(data["num_samples"])
    budget = int(fraction * tot)
    if iid:
        raw_x, raw_y = [], []
        for u in data["users"]:
            raw_x.extend(data["user_data"][u]["x"])
            raw_y.extend(data["user_data"][u]["y"])
        pairs = list(zip(raw_x, raw_y))
        rng.shuffle(pairs)
        pairs = pairs[:budget]
        if iid_num_users is not None:
            num_users = max(1, int(iid_num_users))
        else:
            # reference semantics exactly: int(round(u * num_users)) with a
            # floor of 1 (sample.py:94-96 in the reference's
            # models/utils/sample.py) — it ROUNDS, so 3/147 of 147 users
            # yields 3, not int-truncated 2; exact counts go through
            # iid_num_users
            num_users = max(1, int(round(iid_user_frac * len(data["users"]))))
        groups = iid_divide(pairs, num_users)
        users = [str(i) for i in range(num_users)]
        return {
            "users": users,
            "num_samples": [len(g) for g in groups],
            "user_data": {
                u: {"x": [p[0] for p in g], "y": [p[1] for p in g]}
                for u, g in zip(users, groups)
            },
        }
    # non-iid: random users until budget covered
    order = list(range(len(data["users"])))
    rng.shuffle(order)
    users, num_samples, user_data, used = [], [], {}, 0
    for i in order:
        if used >= budget:
            break
        u = data["users"][i]
        users.append(u)
        num_samples.append(data["num_samples"][i])
        user_data[u] = data["user_data"][u]
        used += data["num_samples"][i]
    return {"users": users, "num_samples": num_samples, "user_data": user_data}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-file", required=True)
    p.add_argument("--fraction", type=float, default=0.1)
    p.add_argument("--iid", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    out = sample_leaf(read_leaf_dir(a.data_dir), a.fraction, a.iid, seed=a.seed)
    write_leaf_json(out, a.out_file)
    print(f"sampled {sum(out['num_samples'])} datapoints over {len(out['users'])} users")


if __name__ == "__main__":
    main()
