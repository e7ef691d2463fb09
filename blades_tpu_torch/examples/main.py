"""The reference CLI's main driver (counterpart: ``scripts/main.py``, after
the reference's ``scripts/main.py:17-57``).

The reference recipe: federated CIFAR-10, the CCT global model
(``CCTNet``), 20 clients of which 8 run IPM, the GeoMed defense, a
client-side Adam (lr 0.1, its state kept across rounds) with MultiStepLR
milestones [150, 300, 500] and gamma 0.5, 600 global rounds of 50 local
steps, an SGD server with lr 1.0, validation every 10 rounds. The JAX
script runs at import; this one runs in :func:`main`::

    python -m blades_tpu_torch.examples.main [--synthetic] [--device cpu]

``--synthetic`` uses the offline stand-in dataset when CIFAR-10's batches
are not under ``./data``; ``--device cpu`` runs on the CPU (the default is
the card). The log goes to ``./outputs``. The recipe has no rounds flag:
600 rounds of CCT-2 at K=20 is the reference's full training run.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from blades_tpu_torch.core import ClientOptSpec
from blades_tpu_torch.datasets import CIFAR10, Synthetic
from blades_tpu_torch.models.cifar10 import CCTNet
from blades_tpu_torch.simulator import Simulator
from blades_tpu_torch.utils.platform import apply_numerics


def main(argv: Optional[List[str]] = None) -> Simulator:
    apply_numerics()
    parser = argparse.ArgumentParser(description="CCT on CIFAR-10, 8 of 20 clients run IPM, "
                                                 "GeoMed")
    parser.add_argument("--synthetic", action="store_true",
                        help="the offline stand-in dataset in place of ./data")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = parser.parse_args(argv)

    if args.synthetic:
        cifar10 = Synthetic(
            num_classes=10, sample_shape=(32, 32, 3),
            train_size=256 * 20, num_clients=20, iid=True,
        )
    else:
        cifar10 = CIFAR10(num_clients=20, iid=True, data_root="./data")

    conf_args = {
        "dataset": cifar10,
        "aggregator": "geomed",  # defense: robust aggregation
        "num_byzantine": 8,  # number of byzantine clients
        "attack": "ipm",  # attack strategy
        "attack_kws": {},
        "seed": 1,  # reproducibility
        "device": args.device,
    }
    simulator = Simulator(**conf_args)

    run_args = {
        "model": CCTNet(),  # global model
        "server_optimizer": "SGD",
        # the reference's torch.optim.Adam(lr=0.1) on the clients (main.py:40)
        "client_optimizer": ClientOptSpec(name="adam", persist=True),
        "loss": "crossentropy",
        "global_rounds": 600,
        "local_steps": 50,
        "server_lr": 1.0,
        "client_lr": 0.1,
        "validate_interval": 10,
        # the reference's MultiStepLR: milestones [150, 300, 500], gamma 0.5
        "client_lr_scheduler": {"milestones": [150, 300, 500], "gamma": 0.5},
    }
    simulator.run(**run_args)
    return simulator


if __name__ == "__main__":
    main()
