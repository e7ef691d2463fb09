"""Run identity, the provenance ledger and anomaly alerts (counterpart:
``examples/run_ledger.py``).

Every entry point of the port mints a ``run_id`` (handed to child
processes through ``BLADES_RUN_ID``/``BLADES_ATTEMPT``), stamps it on every
telemetry record, and appends a ``started`` -> ``finished``/``crashed``/
``killed`` pair to an append-only run ledger (``results/ledger_torch.jsonl``
by default) carrying the config fingerprint, the code version and the
environment's fingerprint. A small rule engine
(``blades_tpu_torch/telemetry/alerts.py``) watches the run's own record
streams live and emits ``alert`` records on divergence, breach storms,
build storms, or shrinking heartbeat margins.

This demo runs three federations against a demo ledger:

1. a healthy run: a ledger pair, the run_id on every trace record;
2. the SAME config again: a different run_id but the same config
   fingerprint ("same experiment, different run" is a string equality,
   which is what lets ``trace_summary --compare`` refuse to diff unrelated
   runs);
3. a deliberately diverging run (absurd client LR): the alert engine
   flags the non-finite/diverging loss in the trace as it happens.

It closes with the ledger query ``blades_tpu_torch/examples/runs.py``
wraps. On the card the median defense runs as stock torch ops: no
kernel launch.

    python -m blades_tpu_torch.examples.run_ledger [--rounds 4] [--out DIR] [--device cpu]

Outputs under ``--out`` (``results/ledger_demo_torch/`` by default,
git-ignored; the demo's ledger is ``<out>/ledger.jsonl``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "ledger_demo_torch"


def _trace(log_dir):
    with open(os.path.join(log_dir, "telemetry.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the three federations; returns what the demo prints: the
    fingerprints, the alerts by run and the ledger's paired runs."""
    apply_numerics()
    p = argparse.ArgumentParser(description="run identity, the provenance ledger and "
                                            "anomaly alerts")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    # point the ledger at the demo directory (the default is the checkout's
    # results/ledger_torch.jsonl; BLADES_LEDGER=0 disables entirely)
    ledger_path = os.path.join(args.out, "ledger.jsonl")
    os.environ["BLADES_LEDGER"] = ledger_path

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.telemetry import ledger

    def run(log_dir, client_lr, rounds=None):
        sim = Simulator(
            dataset=Synthetic(
                num_clients=6, train_size=480, test_size=120, noise=0.3,
                cache=False,
            ),
            num_byzantine=1,
            attack="signflipping",
            aggregator="median",
            log_path=os.path.join(args.out, log_dir),
            seed=0,
            device=args.device,
        )
        rounds = rounds or args.rounds
        sim.run(
            "mlp", global_rounds=rounds, local_steps=1,
            client_lr=client_lr, train_batch_size=8,
            validate_interval=rounds,
        )
        return _trace(os.path.join(args.out, log_dir))

    healthy = run("healthy", client_lr=0.2)
    rerun = run("rerun", client_lr=0.2)
    # the loss-divergence rule compares two trailing windows of 3 rounds,
    # so the seeded blow-up needs at least 6 rounds to show itself
    diverged = run("diverging", client_lr=500.0,
                   rounds=max(8, args.rounds))

    # 1. every record of a run carries its run_id/attempt envelope
    rid = healthy[0]["run_id"]
    stamped = all(
        r.get("run_id") == rid and r.get("attempt") == 1 for r in healthy
    )
    print(f"healthy run {rid}: {len(healthy)} records, "
          f"all stamped with run_id/attempt: {stamped}")

    # 2. same experiment config -> same fingerprint, different run_id
    fp_a = healthy[0]["config_fingerprint"]
    fp_b = rerun[0]["config_fingerprint"]
    print(f"re-run of the same config: run_id {rerun[0]['run_id']} "
          f"(new), config fingerprint {fp_b} "
          f"({'SAME' if fp_a == fp_b else 'DIFFERENT'} as {fp_a})")
    fp_c = diverged[0]["config_fingerprint"]
    print(f"diverging run's fingerprint {fp_c} differs: {fp_c != fp_a}")

    # 3. the alert engine flagged the seeded divergence live, in-trace
    alerts = [r for r in diverged if r["t"] == "alert"]
    print(f"\nalerts on the diverging run ({len(alerts)}):")
    for a in alerts:
        print(f"  [{a['severity']}] {a['rule']}: {a['message']}")
    quiet = [r for r in healthy + rerun if r["t"] == "alert"]
    print(f"alerts on the two healthy runs: {len(quiet)}")

    # 4. the ledger knows every run's provenance and outcome
    print(f"\nledger {ledger_path}:")
    paired = ledger.pair_runs(ledger.read_ledger(ledger_path))
    for run_row in paired:
        metrics = run_row.get("metrics") or {}
        print(f"  {run_row['run_id']} attempt {run_row['attempt']} "
              f"[{run_row['kind']}] config {run_row.get('config_fingerprint')} "
              f"code {str(run_row.get('code_version'))[:10]} -> "
              f"{run_row['outcome']} "
              f"({metrics.get('rounds_completed')} rounds)")
    return {"stamped": stamped, "fingerprints": [fp_a, fp_b, fp_c],
            "same_config_same_fingerprint": fp_a == fp_b, "diverging_differs": fp_c != fp_a,
            "alerts": [{n: a[n] for n in ("rule", "severity", "round")
                        if n in a} for a in alerts],
            "healthy_alerts": len(quiet), "ledger": ledger_path, "runs": paired}


if __name__ == "__main__":
    main()
