"""Dataset statistics (reference: ``models/utils/stats.py``): user count,
sample count, and per-user sample distribution of a LEAF data dir.

Counterpart: ``blades_tpu/leaf/stats.py``, copied line for line (the port
imports nothing of the JAX package), so that Python's seeded ``random``
gives the same users, splits and bytes. No torch.
"""

from __future__ import annotations

import argparse

import numpy as np

from blades_tpu_torch.leaf.util import read_leaf_dir


def leaf_stats(data):
    ns = np.asarray(data["num_samples"])
    return {
        "num_users": len(data["users"]),
        "num_samples": int(ns.sum()),
        "mean": float(ns.mean()) if len(ns) else 0.0,
        "std": float(ns.std()) if len(ns) else 0.0,
        "min": int(ns.min()) if len(ns) else 0,
        "max": int(ns.max()) if len(ns) else 0,
        "percentiles": {
            str(q): float(np.percentile(ns, q)) for q in (10, 25, 50, 75, 90)
        }
        if len(ns)
        else {},
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", required=True)
    a = p.parse_args(argv)
    s = leaf_stats(read_leaf_dir(a.data_dir))
    for k, v in s.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
