"""Per-round metrics that survive fused execution (counterpart:
``examples/metrics_trace.py``).

Round blocks (``block_size=N``, one captured CUDA graph replayed on the
card) and the streaming client axis hide the inside of a round from
host-side spans. The metric pack (``Simulator.run(round_metrics=True)``,
``telemetry/metric_pack.py``) restores the per-round signal from inside
the round: update-norm quantiles and a fixed-log-bin histogram,
honest-against-byzantine cosine to the aggregate, participation counts,
one ``metrics`` telemetry record per round.

This demo runs the same seeded sign-flipping federation twice, round by
round and as one block of all its rounds, and shows that the per-round
``metrics`` records are identical under the two schedules, with the
byzantine cosine pointing away from the honest one. It closes with the
run's ``memory`` record (on the card: argument, output and temporary
bytes) beside the ``engine.peak_update_bytes`` gauge.

    python -m blades_tpu_torch.examples.metrics_trace [--rounds 4] [--device cpu]

Outputs under ``--out`` (``results/metrics_demo_torch/`` by default,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "metrics_demo_torch"


def _metrics_records(log_path: str):
    path = os.path.join(log_path, "telemetry.jsonl")
    out = {"metrics": [], "memory": [], "gauges": {}}
    with open(path) as fh:
        for line in fh:
            r = json.loads(line)
            if r["t"] == "metrics":
                out["metrics"].append(r)
            elif r["t"] == "memory":
                out["memory"].append(r)
            elif r["t"] == "round":
                out["gauges"] = r.get("gauges") or out["gauges"]
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="per-round metric records, round by round and "
                                            "as one block")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    def run(log_dir, **kw):
        sim = Simulator(
            dataset=Synthetic(num_clients=8, train_size=640, test_size=160, noise=0.3,
                              cache=False),
            num_byzantine=2,
            attack="signflipping",
            aggregator="median",
            log_path=log_dir,
            seed=0,
            device=args.device,
        )
        sim.run("mlp", global_rounds=args.rounds, local_steps=1, client_lr=0.2,
                train_batch_size=8, validate_interval=args.rounds, round_metrics=True, **kw)
        return _metrics_records(log_dir)

    seq = run(os.path.join(args.out, "per_round"))
    blk = run(os.path.join(args.out, "block"), block_size=args.rounds)

    print(f"{'round':>5} {'norm_median':>12} {'cos_honest':>11} "
          f"{'cos_byz':>8} {'participants':>13}")
    for m in seq["metrics"]:
        print(f"{m['round']:>5} {m['norm_median']:>12.4f} "
              f"{m['cos_honest']:>11.3f} {m['cos_byz']:>8.3f} "
              f"{m['participants']:>13}")

    same = len(seq["metrics"]) == len(blk["metrics"]) == args.rounds and all(
        a["norm_hist"] == b["norm_hist"]
        and a["participants"] == b["participants"]
        and abs(a["cos_honest"] - b["cos_honest"]) < 1e-5
        for a, b in zip(seq["metrics"], blk["metrics"])
    )
    print(f"\nper-round metrics identical under block_size={args.rounds}: {same}")
    byz_away = sum(1 for m in seq["metrics"] if m["cos_byz"] < m["cos_honest"])
    print(f"rounds where byzantine cosine < honest cosine: "
          f"{byz_away}/{len(seq['metrics'])} (signflipping points away)")

    if seq["memory"]:
        mem = seq["memory"][0]
        print(f"\nmeasured program profile ({mem['program']}): "
              f"argument_bytes={mem.get('argument_bytes')} "
              f"output_bytes={mem.get('output_bytes')} temp_bytes={mem.get('temp_bytes')}")
    peak = seq["gauges"].get("engine.peak_update_bytes")
    if peak:
        print(f"analytical peak_update_bytes gauge: {peak} ({peak / 1e6:.1f} MB)")
    return {"identical_under_block": same, "byz_away": byz_away,
            "rounds": len(seq["metrics"]), "per_round": seq, "block": blk}


if __name__ == "__main__":
    main()
