"""Simulation on MNIST: a 5-aggregator sweep under the IPM attack
(counterpart: ``examples/simulation_on_mnist.py``).

After the reference's ``src/blades/examples/Simulation on MNIST.py``: 20
clients, 8 Byzantine running IPM with epsilon=100, sweeping the
aggregators {mean, trimmedmean, geomed, median, clippedclustering} for 10
global rounds of 10 local steps, then reading each run's ``test`` records
(the reference's ``read_json``, lines 69-83) and plotting the accuracy
curves side by side. ``trimmedmean`` (b=8) is the card's kernel once a
round.

Expected shape (the IPM paper, "Fall of Empires"): ``mean`` is reversed
outright; the coordinate-wise ``median`` and ``trimmedmean`` are subtly
reversed; ``geomed`` and ``clippedclustering`` stay aligned and train.

Data: the MNIST IDX files under ``--data-root`` when present, else the
:class:`Synthetic` stand-in.

    python -m blades_tpu_torch.examples.simulation_on_mnist [--rounds 10] [--device cpu]

Outputs under ``--out`` (``results/mnist_sweep_torch/`` by default,
git-ignored): each run's logs, ``summary.json`` and ``mnist_sweep.png``
(where matplotlib imports).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import (
    REPO,
    build_dataset,
    plot_or_skip,
    seed_stats,
)
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "mnist_sweep_torch"

# the reference's sweep table ("Simulation on MNIST.py" lines 49-55)
AGGS = {
    "mean": {},
    "trimmedmean": {"num_byzantine": 8},
    "geomed": {},
    "median": {},
    "clippedclustering": {},
}

# categorical palette, fixed slot order
COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4"]


def read_test_records(log_root: str):
    """The ``test`` records of a run's stats log (the reference's
    ``read_json``, "Simulation on MNIST.py" lines 69-83)."""
    from blades_tpu_torch.utils.logging import read_stats

    return read_stats(log_root, type_filter="test")


def plot(curves: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=150)
    for color, (agg, tests) in zip(COLORS, curves.items()):
        ax.plot([t["Round"] for t in tests], [100.0 * t["top1"] for t in tests],
                lw=2, color=color, label=agg)
    ax.set_xlabel("Round")
    ax.set_ylabel("Test top-1 accuracy (%)")
    ax.set_title("20 clients, 8×IPM (ε=100): aggregator sweep")
    ax.grid(True, color="#e6e6e3", lw=0.6)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.legend(frameon=False, loc="lower right", ncols=2)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    print("plot:", path)


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="5-aggregator sweep under IPM (epsilon=100)")
    p.add_argument("--data-root", default=str(REPO / "data"))
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--seeds", type=int, nargs="+", default=[1],
                   help="repeat the sweep per seed; finals reported as "
                        "mean [min-max] in summary.json")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from blades_tpu_torch import Simulator

    curves = {}
    finals = {agg: {} for agg in AGGS}
    for agg, agg_kws in AGGS.items():
        for seed in args.seeds:
            tag = f"{agg}_logs" if seed == args.seeds[0] else f"{agg}_s{seed}_logs"
            ds, kind = build_dataset(args.data_root, num_clients=20, seed=seed)
            sim = Simulator(
                dataset=ds,
                aggregator=agg,
                aggregator_kws=agg_kws,
                num_byzantine=8,
                attack="ipm",
                attack_kws={"epsilon": 100},
                log_path=os.path.join(args.out, tag),
                seed=seed,
                device=args.device,
            )
            sim.run(
                model="mlp",
                server_optimizer="SGD",
                client_optimizer="SGD",
                loss="crossentropy",
                global_rounds=args.rounds,
                local_steps=10,
                server_lr=1.0,
                client_lr=0.1,
            )
            tests = read_test_records(os.path.join(args.out, tag))
            finals[agg][seed] = tests[-1]["top1"]
            if seed == args.seeds[0]:
                curves[agg] = tests
            print(f"{agg} seed {seed}: final top1 = {tests[-1]['top1']:.4f}  ({kind})")

    summary = {
        "config": f"20 clients, 8xIPM eps=100, {args.rounds} rounds x 10 local steps",
        "seeds": args.seeds,
        "final_top1": {a: seed_stats(v.values()) for a, v in finals.items()},
        "final_top1_per_seed": finals,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    plot_or_skip(plot, curves, os.path.join(args.out, "mnist_sweep.png"))
    return summary


if __name__ == "__main__":
    main()
