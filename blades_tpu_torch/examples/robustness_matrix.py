"""Robustness matrix: every built-in attack against every major defense
(counterpart: ``examples/robustness_matrix.py``).

A grid of attacked training runs, {none, noise, labelflipping,
signflipping, alie, ipm} x {mean, median, trimmedmean, geomed, krum,
clippedclustering, dnc, signguard}, each 20 clients (8 Byzantine) for
``--rounds`` rounds of 10 local steps on the MNIST-shaped task, reporting
the final test top-1 of each cell; the ``trimmedmean`` column is the
card's kernel once a round (b=8). ``--attacks`` and ``--aggs`` run a
sub-grid, merged into an existing ``matrix.json`` of the same rounds and
seed; the expectations are checked once the grid is whole.

    python -m blades_tpu_torch.examples.robustness_matrix [--device cpu] [--rounds 20]

Outputs under ``--out`` (``results/matrix_torch/`` by default,
git-ignored, never the JAX package's committed ``results/matrix/``):
``matrix.json`` and each run's stats log; with the whole grid also
``summary.json`` (every expectation's verdict), ``attack_success.json``
and the heatmap ``matrix.png`` (where matplotlib imports).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO, plot_or_skip
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "matrix_torch"

ATTACKS = ["none", "noise", "labelflipping", "signflipping", "alie", "ipm"]
AGGS = ["mean", "median", "trimmedmean", "geomed", "krum",
        "clippedclustering", "dnc", "signguard"]
K, BYZ = 20, 8


# defenses that take the attacker-budget assumption as a constructor arg;
# the defender's assumed f is held at the true BYZ for every cell
BUDGET_AGGS = {"trimmedmean", "krum", "dnc"}

# Per-cell expectations (the JAX package's table, which
# tests/test_matrix_summary.py checks there): the matrix is a regression
# gate, not just logs and a PNG. Bounds carry ~0.1 margin vs
# the committed 20-round seed-1 measurements to tolerate seed noise while
# still catching a defense that silently stops working (or an attack that
# silently stops biting). Notable rows: sign-symmetric defenses (median /
# trimmedmean / signguard) break under signflipping; Krum-family and
# distance-based defenses (median/trimmedmean/geomed/krum) collapse under
# IPM because the 8 byzantine rows are IDENTICAL (-eps * honest mean), give
# each other zero pairwise distance, and win every nearest-neighbor
# selection — DnC and clipped clustering are the only defenses that hold
# every row.
#   rule: ("min", x) = defense holds, top1 >= x
#         ("max", x) = attack wins,   top1 <= x
#         ("range", lo, hi) = degraded but not destroyed
#         ("band_rel", lo, d) = defense holds (top1 >= lo) BUT the attack
#             still measurably bites: top1 <= this column's "none" cell - d.
#             Used where absolute floors are too loose to catch an
#             attack-becomes-no-op regression (VERDICT r4 weak #5): ALIE's
#             measured damage on median/trimmedmean is -0.126/-0.119 at
#             seed 1 and replicates at -0.165/-0.160 (seed 2) and
#             -0.167/-0.161 (seed 3), so d=0.05 leaves seed room while a
#             stubbed-out ALIE (attacked == unattacked) fails the cell.
#             The other ALIE columns measured deltas within seed noise
#             (mean ~+0.05; geomed/krum sign-flip across seeds; dnc
#             slightly negative at every seed) — no relative bound is
#             supportable there, so they keep absolute floors. Floors sit
#             below the THREE-seed measured range (seeds 1-3 committed as
#             results/matrix{,_s2,_s3}) but far above a broken defense
#             (collapse ~0.07-0.25): e.g. dnc's lowest cell across seeds
#             is 0.612 (ipm, seed 3) vs its 0.58 floor.
EXPECTATIONS = {
    "none": {agg: ("min", 0.50) for agg in AGGS},
    "noise": {
        "mean": ("max", 0.30),
        **{a: ("min", 0.55) for a in
           ("median", "trimmedmean", "clippedclustering", "dnc",
            "signguard")},
        # geomed/krum measured [0.545, 0.607] across seeds 1-3 — floor
        # below that range, far above a broken defense (noise vs mean
        # collapses to ~0.09-0.11)
        "geomed": ("min", 0.52),
        "krum": ("min", 0.52),
    },
    "labelflipping": {
        "mean": ("range", 0.25, 0.55),
        "median": ("range", 0.25, 0.55),
        "trimmedmean": ("range", 0.25, 0.55),
        "geomed": ("min", 0.50),
        "krum": ("min", 0.50),
        "clippedclustering": ("min", 0.50),
        "dnc": ("min", 0.58),
        "signguard": ("range", 0.35, 0.70),
    },
    "signflipping": {
        "mean": ("max", 0.30),
        "median": ("max", 0.30),
        "trimmedmean": ("max", 0.30),
        "signguard": ("max", 0.30),
        "geomed": ("min", 0.50),
        "krum": ("min", 0.50),
        "clippedclustering": ("min", 0.50),
        "dnc": ("min", 0.58),
    },
    "alie": {
        **{a: ("min", 0.50) for a in AGGS},
        "median": ("band_rel", 0.48, 0.05),
        "trimmedmean": ("band_rel", 0.48, 0.05),
        # [0.492, 0.563] measured across seeds 1-3
        "clippedclustering": ("min", 0.47),
        "dnc": ("min", 0.58),
    },
    "ipm": {
        "mean": ("range", 0.10, 0.50),
        "median": ("max", 0.20),
        "trimmedmean": ("max", 0.20),
        "geomed": ("max", 0.20),
        "krum": ("max", 0.20),
        "signguard": ("range", 0.25, 0.60),
        "clippedclustering": ("min", 0.50),
        "dnc": ("min", 0.58),
    },
}


def evaluate_expectations(matrix):
    """Check every expectation against a measured matrix; returns (rows,
    all_ok) where rows carry per-cell verdicts for summary.json."""
    rows = []
    ok_all = True
    for attack, cells in EXPECTATIONS.items():
        for agg, rule in cells.items():
            value = matrix.get(attack, {}).get(agg)
            baseline = matrix.get("none", {}).get(agg)
            if value is None:
                ok = False
            elif rule[0] == "min":
                ok = value >= rule[1]
            elif rule[0] == "max":
                ok = value <= rule[1]
            elif rule[0] == "band_rel":
                ok = baseline is not None and (
                    rule[1] <= value <= baseline - rule[2]
                )
            else:
                ok = rule[1] <= value <= rule[2]
            ok_all = ok_all and ok
            rows.append(
                {"attack": attack, "agg": agg, "rule": list(rule),
                 "top1": value, "ok": bool(ok)}
            )
    return rows, ok_all


def run_cell(ds, attack: str, agg: str, rounds: int, out_dir: str, seed: int = 1,
             device=None) -> float:
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.utils.logging import read_stats

    log_path = os.path.join(out_dir, f"{attack}__{agg}")
    sim = Simulator(
        dataset=ds,
        aggregator=agg,
        aggregator_kws={"num_byzantine": BYZ} if agg in BUDGET_AGGS else {},
        num_byzantine=0 if attack == "none" else BYZ,
        attack=None if attack == "none" else attack,
        log_path=log_path,
        seed=seed,
        device=device,
    )
    sim.run(
        model="mlp",
        global_rounds=rounds,
        local_steps=10,
        server_lr=1.0,
        client_lr=0.1,
        validate_interval=rounds,
    )
    return float(read_stats(log_path, type_filter="test")[-1]["top1"])


def plot(matrix, path: str) -> None:
    """Sequential single-hue heatmap, per-cell value labels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    data = np.array([[matrix[a][g] for g in AGGS] for a in ATTACKS])
    fig, ax = plt.subplots(figsize=(9.5, 5), dpi=150)
    im = ax.imshow(data, cmap="Blues", vmin=0.0, vmax=1.0)
    ax.set_xticks(range(len(AGGS)), AGGS, rotation=30, ha="right")
    ax.set_yticks(range(len(ATTACKS)), ATTACKS)
    ax.set_xlabel("Aggregator (defense)")
    ax.set_ylabel("Attack (8 of 20 clients)")
    ax.set_title("Final test top-1 after attacked training")
    for i in range(len(ATTACKS)):
        for j in range(len(AGGS)):
            v = data[i, j]
            ax.text(j, i, f"{100 * v:.0f}", ha="center", va="center",
                    fontsize=8, color="white" if v > 0.55 else "#333")
    fig.colorbar(im, ax=ax, shrink=0.8, label="top-1 accuracy")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    print("plot:", path)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the grid (or the ``--attacks`` x ``--aggs`` sub-grid); returns
    the merged matrix."""
    apply_numerics()
    p = argparse.ArgumentParser(description="every attack against every major defense")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--seed", type=int, default=1,
                   help="training seed per cell (the dataset partition stays "
                        "seed-1 so cells differ only by trajectory)")
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--attacks", nargs="*", default=ATTACKS)
    p.add_argument("--aggs", nargs="*", default=AGGS)
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from blades_tpu_torch.examples.convergence_config1 import build_dataset

    ds, _ = build_dataset(str(REPO / "data"), num_clients=K, seed=1)

    # merge into any existing matrix so partial re-runs (one defense
    # column, say) refresh it instead of truncating it
    matrix_path = os.path.join(args.out, "matrix.json")
    matrix = {}
    if os.path.exists(matrix_path):
        with open(matrix_path) as f:
            matrix = json.load(f)
        prev_rounds = matrix.get("_rounds")
        prev_seed = matrix.get("_seed", 1)
        if matrix and (prev_rounds != args.rounds or prev_seed != args.seed):
            sys.exit(
                f"refusing to merge --rounds {args.rounds} --seed "
                f"{args.seed} cells into a matrix recorded at "
                f"{prev_rounds} rounds, seed {prev_seed} ({matrix_path}); "
                "match both or use a fresh --out dir"
            )
    matrix["_rounds"] = args.rounds
    matrix["_seed"] = args.seed
    for attack in args.attacks:
        matrix.setdefault(attack, {})
        for agg in args.aggs:
            top1 = run_cell(ds, attack, agg, args.rounds, args.out, args.seed,
                            device=args.device)
            matrix[attack][agg] = top1
            print(f"{attack:14s} x {agg:18s} -> top1 {top1:.3f}", flush=True)

    with open(matrix_path, "w") as f:
        json.dump(matrix, f, indent=2)
    if all(agg in matrix.get(a, {}) for a in ATTACKS for agg in AGGS):
        plot_or_skip(plot, matrix, os.path.join(args.out, "matrix.png"))
        rows, ok = evaluate_expectations(matrix)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(
                {
                    "rounds": matrix["_rounds"],
                    "seed": matrix["_seed"],
                    # every krum cell uses the d^2 paper default
                    "krum_variant": "distance_power=2 (paper default)",
                    "all_ok": ok,
                    "cells": rows,
                },
                f, indent=1,
            )
        # BASELINE.md's third per-config metric: the attacked cell's top-1
        # drop against the same defense's unattacked cell
        success = {
            a: {g: round(matrix["none"][g] - matrix[a][g], 4) for g in AGGS}
            for a in ATTACKS if a != "none" and a in matrix
        }
        with open(os.path.join(args.out, "attack_success.json"), "w") as f:
            json.dump(
                {
                    "definition": "delta_top1[attack][agg] = top1(none, agg)"
                                  " - top1(attack, agg); positive = attack"
                                  " succeeded by that many points",
                    "rounds": matrix["_rounds"],
                    "seed": matrix["_seed"],
                    "delta_top1": success,
                },
                f, indent=1,
            )
        bad = [r for r in rows if not r["ok"]]
        print(f"expectations: {len(rows) - len(bad)}/{len(rows)} ok")
        for r in bad:
            print(f"  FAIL {r['attack']} x {r['agg']}: top1={r['top1']} rule={r['rule']}")
    return matrix


if __name__ == "__main__":
    main()
