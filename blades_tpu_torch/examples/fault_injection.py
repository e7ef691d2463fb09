"""Fault injection and graceful degradation: dropout, NaN clients,
crash and resume (counterpart: ``examples/fault_injection.py``).

1. A small MLP federation with **30% client dropout and 2 NaN-emitting
   clients** under each of krum, median and trimmedmean: every round
   completes, the loss stays finite, and the per-round fault counters
   (participants, dropouts, non-finite exclusions) are read back from the
   telemetry trace. Under a fault model the trimmed mean is its masked
   form, not the card's kernel.
2. The same run **killed mid-flight**: the crash autosave appears in the
   log directory and ``resume=True`` reproduces the uninterrupted run's
   final parameters bit for bit.

The reference has no counterpart: it trains every client every round and
assumes every upload is well-formed (``src/blades/simulator.py:213-244``).

    python -m blades_tpu_torch.examples.fault_injection [--rounds 4] [--device cpu]

Outputs under ``--out`` (``results/faults_demo_torch/`` by default,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "faults_demo_torch"


def fault_counts(log_path):
    """Per-round fault records from the run's telemetry trace."""
    trace = os.path.join(log_path, "telemetry.jsonl")
    if not os.path.exists(trace):  # BLADES_TELEMETRY=0
        return []
    with open(trace) as f:
        return [r for r in map(json.loads, f) if r.get("t") == "faults"]


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="dropout, NaN clients, crash and resume")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--aggs", nargs="+", default=["krum", "median", "trimmedmean"])
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    import numpy as np

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.faults import FaultModel
    from blades_tpu_torch.ops.pytree import ravel

    faults = FaultModel(
        dropout_rate=0.3,          # about 30% of clients miss any given round
        corrupt_clients=(0, 1),    # two permanently NaN-emitting clients
        corrupt_mode="nan",
    )

    def build(agg, sub, seed=0):
        return Simulator(
            dataset=Synthetic(num_clients=8, train_size=800, test_size=160, noise=0.3,
                              cache=False),
            aggregator=agg,
            aggregator_kws={"num_byzantine": 2} if agg != "median" else {},
            log_path=os.path.join(args.out, sub),
            seed=seed,
            device=args.device,
        )

    def flat(sim):
        return ravel(sim.server.state.params, sim.engine.layout).detach().cpu().numpy()

    run_kw = dict(global_rounds=args.rounds, local_steps=2, client_lr=0.2, server_lr=1.0,
                  train_batch_size=8, validate_interval=args.rounds)

    # -- 1. three defenses under dropout and NaN clients ---------------------
    report = {"aggs": {}}
    for agg in args.aggs:
        sim = build(agg, agg)
        sim.run("mlp", fault_model=faults, **run_kw)
        ev = sim.evaluate(args.rounds, 64)
        assert np.isfinite(ev["Loss"]), f"{agg}: loss went non-finite!"
        recs = fault_counts(os.path.join(args.out, agg))
        excl = sum(r["excluded_nonfinite"] for r in recs)
        dropped = sum(r["dropped"] for r in recs)
        parts = [r["participants"] for r in recs]
        report["aggs"][agg] = {"loss": float(ev["Loss"]), "top1": float(ev["top1"]),
                               "participants": parts, "dropped": dropped,
                               "nan_rows_excluded": excl}
        print(f"{agg:12s} loss={ev['Loss']:.4f} top1={ev['top1']:.3f}  "
              f"participants/round={parts}  dropped={dropped} nan_rows_excluded={excl}")

    # -- 2. kill mid-run, resume bit for bit ----------------------------------
    agg = args.aggs[0]
    ref_sim = build(agg, "uninterrupted", seed=3)
    ref_sim.run("mlp", fault_model=faults, **run_kw)
    ref = flat(ref_sim)

    kill_at = max(args.rounds // 2, 1)

    def killer(rnd, state, m):
        if rnd == kill_at:
            raise RuntimeError("simulated mid-run kill")

    crash_log = os.path.join(args.out, "crashed")
    crash_sim = build(agg, "crashed", seed=3)
    try:
        crash_sim.run("mlp", fault_model=faults, on_round_end=killer, **run_kw)
        raise AssertionError("the kill did not fire")
    except RuntimeError:
        pass
    autosave = os.path.join(crash_log, "autosave.npz")
    report["autosave_written"] = os.path.exists(autosave)
    print(f"\nkilled at round {kill_at}; crash autosave written: {report['autosave_written']}")

    resumed = build(agg, "crashed", seed=3)  # the same log dir, so the same autosave
    resumed.run("mlp", fault_model=faults, resume=True, **run_kw)
    exact = bool(np.array_equal(ref, flat(resumed)))
    report["resume_bit_exact"] = exact
    print(f"resumed rounds {kill_at + 1}..{args.rounds}; final params "
          f"bit-identical to the uninterrupted run: {exact}")
    assert exact, "resume was not bit-exact"
    return report


if __name__ == "__main__":
    main()
