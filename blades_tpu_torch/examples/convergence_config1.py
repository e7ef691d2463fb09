"""BASELINE config 1 convergence evidence: ALIE against mean and trimmed mean
(counterpart: ``examples/convergence_config1.py``).

The reference's de-facto smoke test (``src/blades/examples/mini_example.py:19-50``):
MNIST-shaped MLP, 10 clients, 4 of them running the omniscient ALIE
attack, 100 global rounds of 50 local SGD steps (batch 32, client_lr 0.1,
server_lr 1.0, SGD on both sides). Three runs: a no-attack control,
``mean`` under attack and ``trimmedmean`` under attack, whose defense is
the card's trimmed-mean kernel once a round (b=4). ALIE is a stealth
attack (z_max about 0.43 at n=10, f=4), so the expected signature is a
measurable but modest degradation of ``mean`` that the robust aggregator
claws back, every run still converging.

Data: the MNIST IDX files under ``--data-root`` when present, else the
class-prototype :class:`Synthetic` stand-in (same shape, 10 classes).

    python -m blades_tpu_torch.examples.convergence_config1 [--device cpu] [--rounds 100]

Outputs: ``<out>/<tag>_stats`` (each run's stats log), ``<out>/summary.json``
and the accuracy-curve plot ``<out>/config1_convergence.png``; ``--out`` is
``results/config1_torch/`` by default (git-ignored, never the JAX
package's ``results/config1/`` or ``docs/assets/``). The plot needs
matplotlib; without it the run says so on one line and writes the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path
from typing import List, Optional

from blades_tpu_torch.utils.platform import apply_numerics

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "results" / "config1_torch"


def seed_stats(vals):
    """mean/min/max/n_seeds summary of per-seed finals (the summary.json
    schema the evidence scripts share)."""
    vals = list(vals)
    return {
        "mean": sum(vals) / len(vals),
        "min": min(vals),
        "max": max(vals),
        "n_seeds": len(vals),
    }


def plot_or_skip(plot, *args, **kwargs) -> bool:
    """Call ``plot`` where matplotlib imports; otherwise print one line
    saying the plot was skipped and why. Only the picture depends on it:
    every JSON output is written either way."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        print(f"plot skipped: matplotlib does not import ({type(e).__name__}: {e})")
        return False
    plot(*args, **kwargs)
    return True


def build_dataset(data_root: str, num_clients: int, seed: int):
    from blades_tpu_torch.datasets import MNIST, Synthetic

    try:
        ds = MNIST(data_root=data_root, train_bs=32, num_clients=num_clients, seed=seed)
        ds.get_dls()
        return ds, "mnist"
    except FileNotFoundError:
        # noise=0.3 puts the Bayes limit high (about 90% for the MLP
        # centrally) while keeping the task non-trivial
        ds = Synthetic(
            num_classes=10,
            sample_shape=(28, 28, 1),
            train_size=10_000,
            test_size=1_000,
            noise=0.3,
            train_bs=32,
            num_clients=num_clients,
            seed=seed,
            cache=False,
        )
        return ds, "synthetic"


def run_one(aggregator: str, data_root: str, out_dir: str, rounds: int,
            seed: int = 1, attack: str = "alie", tag: str = None, device=None):
    """One config-1 run; returns the parsed ``test`` records and the
    dataset's kind."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.utils.logging import read_stats

    tag = tag or aggregator
    log_path = os.path.join(out_dir, f"{tag}_logs")
    ds, ds_kind = build_dataset(data_root, num_clients=10, seed=seed)
    sim = Simulator(
        dataset=ds,
        aggregator=aggregator,
        num_byzantine=4 if attack else 0,
        attack=attack,
        attack_kws={"num_clients": 10, "num_byzantine": 4} if attack == "alie" else {},
        log_path=log_path,
        seed=seed,
        device=device,
    )
    sim.run(
        model="mlp",
        server_optimizer="SGD",
        client_optimizer="SGD",
        loss="crossentropy",
        global_rounds=rounds,
        local_steps=50,
        server_lr=1.0,
        client_lr=0.1,
        validate_interval=5,
    )
    shutil.copyfile(os.path.join(log_path, "stats"), os.path.join(out_dir, f"{tag}_stats"))
    return read_stats(log_path, type_filter="test"), ds_kind


def plot(curves: dict, path: str, bands: dict = None) -> None:
    """Accuracy-against-round lines (the first seed's curve; the min-max
    band across seeds where there are several)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    colors = {
        "mean+alie": "#2a78d6",
        "trimmedmean+alie": "#eb6834",
        "mean (no attack)": "#1baf7a",
    }
    fig, ax = plt.subplots(figsize=(7, 4.2), dpi=150)
    for agg, tests in curves.items():
        xs = [t["Round"] for t in tests]
        ys = [100.0 * t["top1"] for t in tests]
        ax.plot(xs, ys, lw=2, color=colors.get(agg, "#666"), label=agg)
        if bands and agg in bands and len(bands[agg]) > 1:
            per_round = list(zip(*[[100.0 * t["top1"] for t in run] for run in bands[agg]]))
            lo = [min(v) for v in per_round]
            hi = [max(v) for v in per_round]
            ax.fill_between(xs, lo, hi, color=colors.get(agg, "#666"), alpha=0.15, lw=0)
    ax.set_xlabel("Round")
    ax.set_ylabel("Test top-1 accuracy (%)")
    ax.set_title("Config 1: 10 clients, 4×ALIE (stealth) — with no-attack control")
    ax.set_ylim(0, 100)
    ax.grid(True, color="#e6e6e3", lw=0.6)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.legend(frameon=False, loc="lower right")
    fig.tight_layout()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="BASELINE config 1: ALIE against mean and "
                                            "trimmed mean")
    p.add_argument("--data-root", default=str(REPO / "data"))
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--plot", default=None,
                   help="the plot's path (default: config1_convergence.png in --out)")
    p.add_argument("--seeds", type=int, nargs="+", default=[1],
                   help="run every config once per seed; reports mean and range")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    runs = [
        ("mean (no attack)", "mean", None, "mean_noattack"),
        ("mean+alie", "mean", "alie", "mean_alie"),
        ("trimmedmean+alie", "trimmedmean", "alie", "trimmedmean_alie"),
    ]
    curves, bands, kind = {}, {}, None
    finals = {}
    for label, agg, attack, tag in runs:
        bands[label] = []
        finals[label] = {}
        for seed in args.seeds:
            stag = tag if seed == args.seeds[0] else f"{tag}_s{seed}"
            tests, kind = run_one(agg, args.data_root, args.out, args.rounds, seed=seed,
                                  attack=attack, tag=stag, device=args.device)
            bands[label].append(tests)
            finals[label][seed] = tests[-1]["top1"]
            print(f"{label} seed {seed}: final top1 = {tests[-1]['top1']:.4f}")
        curves[label] = bands[label][0]

    summary = {
        "config": "BASELINE config 1 (mini_example): MLP, 10 clients, "
                  "4xALIE, 100 rounds x 50 local steps",
        "dataset": kind,
        "seeds": args.seeds,
        "final_top1": {a: seed_stats(finals[a].values()) for a in finals},
        "final_top1_per_seed": finals,
        "final_loss": {a: curves[a][-1]["Loss"] for a in curves},
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    plot_or_skip(plot, curves, args.plot or os.path.join(args.out, "config1_convergence.png"),
                 bands=bands)
    print(json.dumps({k: v for k, v in summary.items() if k != "final_top1_per_seed"},
                     indent=2))
    return summary


if __name__ == "__main__":
    main()
