"""
FLTrust: defense bootstrapped from one trusted client
=====================================================

The port's counterpart of ``examples/fltrust_example.py`` (reference
intent: ``src/blades/examples/todo_fltrusted_example.py``, an unfinished
stub upstream; the working pieces are ``Fltrust`` and
``set_trusted_clients``). Mark one client as the trusted root, aggregate
with FLTrust (every update trust-scored by the ReLU'd cosine similarity to
the trusted update and rescaled to its norm), and train through a
15-of-40 sign-flipping population that wrecks plain mean.

    python -m blades_tpu_torch.examples.fltrust_example [--device cpu]

``FT_ROUNDS`` and ``FT_STEPS`` set the rounds and local steps (20 and 10
by default), ``FT_OUT`` the log directory (``./outputs``). From 15 rounds
on, FLTrust must beat mean by more than 0.2 in top-1.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.simulator import Simulator
from blades_tpu_torch.utils.logging import read_stats
from blades_tpu_torch.utils.platform import apply_numerics

ROUNDS = int(os.environ.get("FT_ROUNDS", 20))
STEPS = int(os.environ.get("FT_STEPS", 10))
K, BYZ = 40, 15


def run(aggregator, tag, device=None):
    ds = Synthetic(num_clients=K, train_size=4000, test_size=800, noise=0.3, cache=False)
    log = os.path.join(os.environ.get("FT_OUT", "./outputs"), f"ft_{tag}")
    sim = Simulator(ds, num_byzantine=BYZ, attack="signflipping", aggregator=aggregator,
                    log_path=log, seed=1, device=device)
    # the trusted root must be an honest client (the byzantine ids are the
    # first BYZ); FLTrust requires exactly one
    if aggregator == "fltrust":
        sim.set_trusted_clients([sim.get_clients()[-1].id()])
    sim.run(model="mlp", global_rounds=ROUNDS, local_steps=STEPS, server_lr=1.0,
            client_lr=0.1, validate_interval=ROUNDS)
    top1 = read_stats(log, type_filter="test")[-1]["top1"]
    print(f"{tag:8s} final top-1 = {top1:.3f}")
    return top1


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="FLTrust against mean under sign flipping")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    mean = run("mean", "mean", args.device)
    flt = run("fltrust", "fltrust", args.device)
    # at the full configuration the gap is decisive; below 15 rounds both
    # are near chance and a strict comparison would assert on noise
    if ROUNDS >= 15:
        assert flt > mean + 0.2, (
            f"fltrust ({flt:.3f}) should decisively beat undefended mean "
            f"({mean:.3f}) under 37% signflipping"
        )
    return {"mean": mean, "fltrust": flt}


if __name__ == "__main__":
    main()
