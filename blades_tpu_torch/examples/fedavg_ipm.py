"""Krum-collapse adjudication: fedavg-path IPM against the reference's own
Krum (counterpart: ``examples/fedavg_ipm.py``).

With 20 clients, 8 of them running IPM, 30 fedavg rounds (10 local Adam
steps, persistent moments, MultiStepLR [15, 25] gamma 0.5), the
Krum-defended run collapses while the UNDEFENDED mean trains (the JAX
package's committed ``results/fedavg_ipm``). This script asks, round by
round, whether that is a property of Krum against IPM or a fault of the
implementation: both arms run, and for EVERY round of the Krum arm the
actual post-attack ``[K, D]`` update matrix (``sim.engine.last_updates``)
goes to

1. the port's production Krum (paper scoring, d^2),
2. the port's reference-parity Krum (``distance_power=4``), and
3. where the reference checkout is present, the reference's own ``Krum``
   (``src/blades/aggregators/krum.py``, loaded by
   ``tests/reference_loader.py``),

recording each one's selected row, whether d^2 picked a byzantine row,
and how far the d^2 and d^4 aggregates lie apart. The 8 IPM rows are
bit-identical (every byzantine uploads ``-eps * mean(honest)``), so they
give each other pairwise distance 0 and win the nearest-neighbour score
while the honest updates still carry strong, varied signal; which of the
identical rows a scoring picks is not a property of the defense, so the
record's agreement is ``selected_is_byzantine`` and the aggregate, not the
raw index. Mean, by contrast, still moves in expectation by
``(12 - 8*0.5)/20 = +0.4x`` the honest direction.

Neither arm's defense is the trimmed mean: no kernel launch.

    python -m blades_tpu_torch.examples.fedavg_ipm [--rounds 30] [--steps 10] [--device cpu]

Outputs under ``--out`` (``results/fedavg_ipm_torch/`` by default,
git-ignored): ``adjudication.json`` and ``summary.json`` with the JAX
example's keys.

Reference counterparts: ``attackers/ipmclient.py:4-16``,
``aggregators/krum.py:93-125``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO, build_dataset
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "fedavg_ipm_torch"

K, BYZ = 20, 8


def load_reference_krum():
    """The reference's own Krum, loaded verbatim by the tests' loader; None
    where the reference checkout (the loader's ``REF_SRC``) is absent."""
    tests = str(REPO / "tests")
    if not os.path.isfile(os.path.join(tests, "reference_loader.py")):
        return None
    sys.path.insert(0, tests)
    import reference_loader

    if not os.path.isdir(reference_loader.REF_SRC):
        return None
    return reference_loader.load_reference().aggregators.krum


def run_arm(agg: str, out_dir: str, rounds: int, steps: int, seed: int,
            adjudicate, device=None):
    from blades_tpu_torch import ClientOptSpec, Simulator
    from blades_tpu_torch.utils.logging import read_stats

    ds, kind = build_dataset(os.path.join(str(REPO), "data"), num_clients=K, seed=seed)
    log_path = os.path.join(out_dir, f"ipm_{agg}")
    sim = Simulator(
        dataset=ds,
        aggregator=agg,
        aggregator_kws={"num_byzantine": BYZ} if agg == "krum" else {},
        num_byzantine=BYZ,
        attack="ipm",
        log_path=log_path,
        seed=seed,
        device=device,
    )
    rows = []

    def on_round_end(rnd, state, m):
        if adjudicate and agg == "krum":
            rows.append(adjudicate(rnd, sim.engine.last_updates))

    sim.run(
        model="mlp",
        client_optimizer=ClientOptSpec(name="adam", persist=True),
        client_lr_scheduler={"milestones": [15, 25], "gamma": 0.5},
        global_rounds=rounds,
        local_steps=steps,
        client_lr=0.01,
        server_lr=1.0,
        validate_interval=rounds,
        on_round_end=on_round_end,
    )
    top1 = float(read_stats(log_path, type_filter="test")[-1]["top1"])
    return top1, rows, kind


def make_adjudicator(ref_krum_mod):
    """Per-round comparator: the port's Krum selections (d^2 and d^4) and,
    where loaded, the reference's, on the identical update matrix."""
    import torch

    from blades_tpu_torch.aggregators import get_aggregator

    ours_p2 = get_aggregator("krum", num_byzantine=BYZ)
    ours_p4 = get_aggregator("krum", num_byzantine=BYZ, distance_power=4)

    def adjudicate(rnd, updates):
        sel_p2 = int(torch.argmin(ours_p2.scores(updates)))
        sel_p4 = int(torch.argmin(ours_p4.scores(updates)))
        vec_p2, _ = ours_p2.aggregate(updates)
        vec_p4, _ = ours_p4.aggregate(updates)
        row = {
            "round": rnd,
            "ours_selected": sel_p2,
            "ours_parity_selected": sel_p4,
            "selected_is_byzantine": sel_p2 < BYZ,
            "parity_selected_is_byzantine": sel_p4 < BYZ,
            "d2_d4_aggregate_max_abs_diff": float((vec_p2 - vec_p4).abs().max()),
        }
        if ref_krum_mod is not None:
            u = updates.detach().cpu()
            tv = [u[i].clone() for i in range(len(u))]
            dists = ref_krum_mod._pairwise_euclidean_distances(tv)
            ref_sel = ref_krum_mod._multi_krum(dists, len(u), BYZ, 1)[0]
            ref_vec = ref_krum_mod.Krum(num_clients=len(u), num_byzantine=BYZ)(u.clone())
            row["reference_selected"] = int(ref_sel)
            row["agree_with_reference"] = bool(ref_sel == sel_p4)
            row["aggregate_max_abs_diff"] = float(
                (vec_p4.detach().cpu() - ref_vec).abs().max())
        return row

    return adjudicate


def main(argv: Optional[List[str]] = None) -> dict:
    """Both arms and the adjudication; returns the summary, the verdict
    (its per-round rows included) and the d^2/d^4 agreement."""
    apply_numerics()
    p = argparse.ArgumentParser(description="Krum against IPM on the fedavg path, "
                                            "adjudicated round by round")
    p.add_argument("--rounds", type=int, default=30)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    ref_krum = load_reference_krum()
    adjudicate = make_adjudicator(ref_krum)

    finals = {}
    adj_rows = []
    for agg in ("mean", "krum"):
        top1, rows, kind = run_arm(agg, args.out, args.rounds, args.steps,
                                   args.seed, adjudicate, device=args.device)
        finals[agg] = top1
        adj_rows.extend(rows)
        print(f"{agg}: final top1 = {top1:.4f}")

    agree = [r["agree_with_reference"] for r in adj_rows
             if "agree_with_reference" in r]
    diffs = [r["aggregate_max_abs_diff"] for r in adj_rows
             if "aggregate_max_abs_diff" in r]
    agreement = (sum(agree) / len(agree)) if agree else None
    max_diff = max(diffs) if diffs else None
    byz_picked = [r["selected_is_byzantine"] for r in adj_rows]
    # length of the opening byzantine-captured streak: the phase that
    # decides the run (once the model is wrecked, occasional honest
    # single-client Adam selections cannot recover it)
    streak = 0
    for b in byz_picked:
        if not b:
            break
        streak += 1
    # d^2 against d^4 on the same matrix: the same kind of row picked
    # (byzantine or honest) and the same aggregate
    d2_d4 = [r["selected_is_byzantine"] == r["parity_selected_is_byzantine"]
             and r["d2_d4_aggregate_max_abs_diff"] == 0.0 for r in adj_rows]
    if agree:
        headline = "krum collapse under IPM is genuine, not an implementation bug"
        cross_check = (
            "on every round's actual update matrix the reference's own Krum "
            f"selects the identical row (agreement {agreement}, max aggregate "
            f"diff {max_diff})"
        )
    else:
        # never claim the bug-vs-genuine verdict from a cross-check that did
        # not run
        headline = (
            "krum selection dynamics are consistent with genuine "
            "IPM capture (verdict NOT re-adjudicated here)"
        )
        cross_check = (
            "reference tree not present, so the cross-check did not run; the "
            "JAX package's committed results/fedavg_ipm/adjudication.json "
            "carries the reference-verified run"
        )
    verdict = {
        "rounds_checked": len(adj_rows),
        "reference_available": ref_krum is not None,
        "selection_agreement_with_reference": agreement,
        "fraction_rounds_krum_selected_byzantine":
            sum(byz_picked) / max(1, len(byz_picked)),
        "initial_byzantine_capture_streak": streak,
        "max_aggregate_abs_diff": max_diff,
        "conclusion": (
            f"{headline}: {cross_check}. "
            f"Krum is byzantine-captured for the first {streak} consecutive "
            f"rounds ({sum(byz_picked)}/{len(byz_picked)} overall): the "
            "identical IPM replicas have zero pairwise distance and win "
            "the nearest-neighbor score while the model still has signal; "
            "each captured round applies -eps*mean(honest). Later "
            "honest selections are single-client Adam updates (no "
            "averaging) and cannot recover the wrecked model."
        ),
        "per_round": adj_rows,
    }
    with open(os.path.join(args.out, "adjudication.json"), "w") as f:
        json.dump(verdict, f, indent=1)

    summary = {
        "config": f"fedavg path: {K} clients, {BYZ}xIPM, {args.rounds} "
                  f"rounds x {args.steps} local steps, client Adam "
                  "(persistent moments), MultiStepLR [15,25] g=0.5",
        "note": "BASELINE config-3 algorithm at MNIST scale; selection "
                "defense (krum, f=8) vs undefended mean; see "
                "adjudication.json for the per-round reference cross-check",
        "seed": args.seed,
        "final_top1": finals,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({**summary, "adjudication": {
        k: v for k, v in verdict.items() if k != "per_round"}}, indent=2))
    return {"summary": summary, "verdict": verdict, "dataset": kind,
            "d2_d4_agreement": sum(d2_d4) / max(1, len(d2_d4))}


if __name__ == "__main__":
    main()
