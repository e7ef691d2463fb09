"""
A mini example
==============

The port's counterpart of ``examples/mini_example.py``: federated MNIST, 10
clients of which 4 run the ALIE attack, mean aggregation, the MLP global
model. Run from a directory holding MNIST under ``./data`` (the IDX files,
raw or ``.gz``, or ``mnist.npz``)::

    python -m blades_tpu_torch.examples.mini_example [--synthetic] [--device cpu]

``--synthetic`` uses the offline stand-in dataset; ``--device cpu`` runs on
the CPU (the default is the GPU). ``MINI_ROUNDS`` and ``MINI_STEPS`` set the
rounds and local steps (100 and 50 by default), as in the JAX example. Logs
go to ``./outputs``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from blades_tpu_torch.datasets import MNIST, Synthetic
from blades_tpu_torch.simulator import Simulator


def main(argv: Optional[List[str]] = None) -> Simulator:
    parser = argparse.ArgumentParser(description="federated MNIST under ALIE, mean aggregation")
    parser.add_argument("--synthetic", action="store_true",
                        help="the offline stand-in dataset in place of ./data")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = parser.parse_args(argv)

    if args.synthetic:
        dataset = Synthetic(num_clients=10, train_bs=32, train_size=4000)
    else:
        dataset = MNIST(data_root="./data", train_bs=32, num_clients=10)

    simulator = Simulator(
        dataset=dataset,
        aggregator="mean",  # aggregation
        num_byzantine=4,  # number of Byzantine clients
        attack="alie",  # attack strategy
        attack_kws={"num_clients": 10, "num_byzantine": 4},
        seed=1,  # reproducibility
        device=args.device,
    )
    simulator.run(
        model="mlp",  # global model (reference: MLP())
        server_optimizer="SGD",
        client_optimizer="SGD",
        loss="crossentropy",
        global_rounds=int(os.environ.get("MINI_ROUNDS", 100)),
        local_steps=int(os.environ.get("MINI_STEPS", 50)),
        server_lr=1.0,
        client_lr=0.1,
    )
    return simulator


if __name__ == "__main__":
    main()
