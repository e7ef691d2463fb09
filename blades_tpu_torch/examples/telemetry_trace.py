"""Telemetry trace: span tree, build accounting and defense forensics
(counterpart: ``examples/telemetry_trace.py``).

Every :meth:`Simulator.run` writes a JSONL telemetry trace next to its
``stats`` log (``<log_path>/telemetry.jsonl``) unless ``BLADES_TELEMETRY=0``:
a per-round span tree (sample / dispatch / device sync / eval), the build
provenance (``program`` records) and, with ``collect_diagnostics=True``,
*what the defense decided* each round (here: which coordinates trimmed
mean discarded, and how much of the trimmed mass came from the actual
byzantine clients running ALIE).

The reference has no counterpart for any of this: it logs only whole-round
wall time and loss/accuracy (``src/blades/simulator.py:453-455``).

This demo runs a small MLP federation for a few rounds (on the card, the
trimmed-mean kernel twice a round: the defense and its diagnostics), then
summarizes the trace with the port's reader
(``blades_tpu_torch/examples/trace_summary.py``), the same per-stage cost
table a full-size run gives.

    python -m blades_tpu_torch.examples.telemetry_trace [--rounds 2] [--out DIR] [--device cpu]

Outputs under ``--out`` (``results/telemetry_demo_torch/`` by default,
git-ignored).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "telemetry_demo_torch"


def main(argv: Optional[List[str]] = None) -> Optional[dict]:
    """Run the federation and print the trace's table; returns the
    summary dict (None when ``BLADES_TELEMETRY=0`` wrote no trace)."""
    apply_numerics()
    p = argparse.ArgumentParser(description="span tree, build accounting and defense "
                                            "forensics from a run's own trace")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.examples.trace_summary import format_table, load_records, summarize

    log_path = os.path.join(args.out, "logs")
    sim = Simulator(
        dataset=Synthetic(
            num_clients=8, train_size=800, test_size=160, noise=0.3, cache=False
        ),
        num_byzantine=2,
        attack="alie",
        aggregator="trimmedmean",
        aggregator_kws={"num_byzantine": 2},
        log_path=log_path,
        seed=0,
        device=args.device,
    )
    times = sim.run(
        "mlp",
        global_rounds=args.rounds,
        local_steps=2,
        client_lr=0.2,
        server_lr=1.0,
        train_batch_size=8,
        validate_interval=args.rounds,
        collect_diagnostics=True,
    )

    trace = os.path.join(log_path, "telemetry.jsonl")
    if not os.path.exists(trace):
        # the run itself is unaffected by the kill switch; there is just
        # nothing to summarize
        print("BLADES_TELEMETRY=0: no trace written "
              f"(run completed in {sum(times):.3f}s)")
        return None
    summary = summarize(load_records(trace))
    print(format_table(summary))
    round_total = summary["spans"]["round"]["total_s"]
    print(f"\nengine round wall total: {sum(times):.3f}s "
          f"(trace round-span total: {round_total:.3f}s)")
    # the forensic signal: how much of what the defense trimmed was byzantine
    byz_trim = summary["defense"].get("mean_byz_trim_frac")
    if byz_trim is not None:
        print(f"byz share of trimmed coordinate-slots: {byz_trim:.2f} "
              f"(2 of 8 clients byzantine -> blind trimming would give 0.25)")
    return summary


if __name__ == "__main__":
    main()
