"""
Customization of aggregation scheme
===================================

The port's counterpart of ``examples/customize_aggregator.py`` (reference
intent: ``src/blades/examples/todo_customize_aggregator.py``, an unfinished
stub upstream; the accepted surfaces are the callable path in
``simulator.py:110-116`` and subclassing ``_BaseAggregator``). Both work:

1. a **bare callable** ``[K, D] updates -> [D] aggregate``, wrapped by
   ``aggregators/__init__.py:_wrap_callable``;
2. an :class:`blades_tpu_torch.aggregators.Aggregator` **subclass**, with
   full control, including explicit cross-round state.

Both are run against 4 of 12 clients running IPM and compared to plain
mean. The subclass is a norm-capped mean: each update's L2 norm is clipped
to a running median of past round norms.

    python -m blades_tpu_torch.examples.customize_aggregator [--device cpu]

``CA_ROUNDS`` and ``CA_STEPS`` set the rounds and local steps (20 and 10 by
default), ``CA_OUT`` the log directory (``./outputs``).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.datasets import Synthetic
from blades_tpu_torch.simulator import Simulator
from blades_tpu_torch.utils.logging import read_stats
from blades_tpu_torch.utils.platform import apply_numerics

ROUNDS = int(os.environ.get("CA_ROUNDS", 20))
STEPS = int(os.environ.get("CA_STEPS", 10))


def trimmed_like_callable(updates):
    """Surface 1: a plain function. Coordinate-wise midhinge: mean of the
    25th and 75th percentile per coordinate, cheap and outlier-resistant
    (``torch.quantile``'s linear interpolation is ``jnp.percentile``'s)."""
    lo = torch.quantile(updates, 0.25, dim=0)
    hi = torch.quantile(updates, 0.75, dim=0)
    return 0.5 * (lo + hi)


class NormCappedMean(Aggregator):
    """Surface 2: an Aggregator subclass with explicit cross-round state.

    State = running estimate of the honest update norm; each round every
    update is rescaled to at most that norm before averaging, then the
    estimate moves toward this round's median norm (the mean of the two
    middle norms for an even K, as ``jnp.median`` takes it).
    """

    stateful = True

    def init_state(self, num_clients, dim):
        return torch.tensor(1.0, dtype=torch.float32)  # initial norm cap

    def aggregate(self, updates, state=(), **ctx):
        cap = state.to(updates.device, updates.dtype)
        norms = torch.linalg.vector_norm(updates, dim=1)
        scale = torch.clamp(cap / torch.clamp_min(norms, 1e-12), max=1.0)
        clipped = updates * scale[:, None]
        new_cap = 0.7 * cap + 0.3 * torch.quantile(norms, 0.5)
        return clipped.mean(dim=0), new_cap

    def __repr__(self):
        return "NormCappedMean"


def run(agg, tag, device=None):
    ds = Synthetic(num_clients=12, train_size=2400, test_size=480, noise=0.3, cache=False)
    log = os.path.join(os.environ.get("CA_OUT", "./outputs"), f"ca_{tag}")
    sim = Simulator(ds, num_byzantine=4, attack="ipm", aggregator=agg, log_path=log, seed=1,
                    device=device)
    sim.run(model="mlp", global_rounds=ROUNDS, local_steps=STEPS, server_lr=1.0,
            client_lr=0.1, validate_interval=ROUNDS)
    top1 = read_stats(log, type_filter="test")[-1]["top1"]
    print(f"{tag:16s} final top-1 = {top1:.3f}")
    return top1


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="a callable and an Aggregator subclass as defenses")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)
    return {
        "mean": run("mean", "mean", args.device),
        "callable": run(trimmed_like_callable, "callable", args.device),
        "subclass": run(NormCappedMean(), "subclass", args.device),
    }


if __name__ == "__main__":
    main()
