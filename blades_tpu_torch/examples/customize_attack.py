"""
Customization of attack strategy
================================

The port's counterpart of ``examples/customize_attack.py`` (reference
flow: subclass ``ByzantineClient`` and override lifecycle methods,
``src/blades/examples/customize_attack.py``). Subclass
:class:`blades_tpu_torch.attackers.Attack` for the transform and attach it
to a :class:`blades_tpu_torch.client.ByzantineClient`; the hooks see the
whole client axis, the byzantine rows marked by a ``[K]`` mask:

- ``on_grads``: corrupt per-step gradients (in place of overriding
  ``local_training`` for sign-flip-style attacks);
- ``on_batch``: modify each training batch (``on_train_batch_begin``);
- ``on_updates``: full omniscient knowledge, rewrite rows of the ``[K, D]``
  update matrix (``omniscient_callback``).

    python -m blades_tpu_torch.examples.customize_attack [--synthetic] [--device cpu]

``--synthetic`` uses the offline stand-in dataset in place of MNIST under
``./data``; ``--device cpu`` runs on the CPU (the default is the card).
The run is ``ROUNDS`` rounds of ``STEPS`` local steps (50 and 50, the JAX
example's); the log goes to ``./outputs``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from blades_tpu_torch.attackers.base import Attack, honest_stats
from blades_tpu_torch.client import ByzantineClient
from blades_tpu_torch.datasets import MNIST, Synthetic
from blades_tpu_torch.simulator import Simulator
from blades_tpu_torch.utils.platform import apply_numerics

ROUNDS, STEPS = 50, 50


class MaliciousAttack(Attack):
    """Sign-flips gradients, flips labels, and uploads -100x the honest
    mean: the reference example's triple attack."""

    trains_dishonestly = True

    def __init__(self, num_classes=10):
        self.num_classes = num_classes

    def on_batch(self, x, y, byz_mask, *, num_classes, generator=None, client_idx=None):
        byz = byz_mask.view(-1, *([1] * (y.dim() - 1)))
        return x, torch.where(byz, self.num_classes - 1 - y, y)

    def on_grads(self, grads, byz_mask, client_idx=None):
        def flip(g):
            sign = torch.where(byz_mask, -1.0, 1.0).to(g.dtype)
            return g * sign.view(-1, *([1] * (g.dim() - 1)))

        return {n: flip(g) for n, g in grads.items()}

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        mu, _, _ = honest_stats(updates, byz_mask)
        return torch.where(byz_mask[:, None], -100.0 * mu[None, :], updates), state


class MaliciousClient(ByzantineClient):
    def make_attack(self):
        return MaliciousAttack()


def main(argv: Optional[List[str]] = None) -> Simulator:
    apply_numerics()
    p = argparse.ArgumentParser(description="a custom attack on registered Byzantine clients")
    p.add_argument("--synthetic", action="store_true",
                   help="the offline stand-in dataset in place of ./data")
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    if args.synthetic:
        dataset = Synthetic(num_clients=10, train_bs=32, train_size=4000)
    else:
        dataset = MNIST(data_root="./data", train_bs=32, num_clients=10)

    simulator = Simulator(
        dataset=dataset,
        aggregator="clippedclustering",  # defense: robust aggregation
        seed=1,
        device=args.device,
    )
    # the first 5 clients become the custom attacker
    simulator.register_attackers([MaliciousClient() for _ in range(5)])

    simulator.run(
        model="mlp",
        server_optimizer="SGD",
        client_optimizer="SGD",
        loss="crossentropy",
        global_rounds=ROUNDS,
        local_steps=STEPS,
        server_lr=1.0,
        client_lr=0.1,
    )
    return simulator


if __name__ == "__main__":
    main()
