"""
Comparing built-in aggregation schemes
======================================

Counterpart: ``examples/plot_comparing_aggregation_schemes.py``; reference:
``src/blades/examples/plot_comparing_aggregation_schemes.py``. 60 benign
2-D Gaussian samples + 40 outliers pushed through every aggregator; robust
ones must land inside the benign cluster. ``trimmedmean``'s default b=5
takes the card's kernel on the ``[100, 2]`` matrix.

    python -m blades_tpu_torch.examples.plot_comparing_aggregation_schemes --device cpu

The plot goes to ``--out`` (``$AGG_PLOT_OUT``, else
``results/aggregation_schemes_torch/aggregation_schemes.png``, git-ignored)
where matplotlib imports; without it one line says so.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from blades_tpu_torch.examples.convergence_config1 import REPO, plot_or_skip
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "aggregation_schemes_torch" / "aggregation_schemes.png"

#: fltrust needs a designated trusted row; byzantinesgd needs the
#: params_flat/round context the engine threads through: both are
#: exercised in tests/test_torch_aggregators.py instead
SKIPPED = ("fltrust", "byzantinesgd")


def points(seed: int = 1):
    """The benign ``[60, 2]`` and outlier ``[40, 2]`` samples (NumPy's
    legacy generator at ``seed``, the JAX example's ``np.random.seed(1)``)."""
    rs = np.random.RandomState(seed)
    benign = rs.normal(0.0, 1.0, (60, 2))
    outlier = rs.normal(7.0, 1.0, (40, 2))
    return benign, outlier


def plot(benign, outlier, results: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.scatter(benign[:, 0], benign[:, 1], s=8, alpha=0.4, label="benign")
    plt.scatter(outlier[:, 0], outlier[:, 1], s=8, alpha=0.4, label="outlier")
    for name, p in results.items():
        plt.scatter(*p, marker="x", s=60)
        plt.annotate(name, p, fontsize=7)
    plt.legend()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plt.savefig(path, dpi=120)
    plt.close()
    print(f"wrote {path}")


def main(argv: Optional[List[str]] = None) -> dict:
    """Every aggregator but :data:`SKIPPED` on the ``[100, 2]`` matrix;
    returns ``{name: {"aggregate": [x, y], "dist": float, "tag": str}}``."""
    apply_numerics()
    p = argparse.ArgumentParser(description="every built-in aggregator on 60 benign and "
                                            "40 outlier 2-D points")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    p.add_argument("--out", default=os.environ.get("AGG_PLOT_OUT", str(DEFAULT_OUT)))
    args = p.parse_args(argv)

    import torch

    from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator
    from blades_tpu_torch.core.engine import resolve_device

    benign, outlier = points()
    data = torch.as_tensor(np.concatenate([benign, outlier]).astype(np.float32),
                           device=resolve_device(args.device))

    results, out = {}, {}
    for name in sorted(AGGREGATORS):
        if name in SKIPPED:
            continue
        agg = get_aggregator(name)
        results[name] = agg(data).cpu().numpy()
        dist = float(np.linalg.norm(results[name] - benign.mean(0)))
        tag = "ROBUST" if dist < 1.0 else "pulled"
        out[name] = {"aggregate": results[name].tolist(), "dist": dist, "tag": tag}
        print(f"{name:18s} -> {np.round(results[name], 3)}  "
              f"(dist to benign mean: {dist:5.2f}) {tag}")
    plot_or_skip(plot, benign, outlier, results, args.out)
    return out


if __name__ == "__main__":
    main()
