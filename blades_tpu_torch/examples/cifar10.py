"""The reference CLI's CIFAR-10 driver (counterpart: ``scripts/cifar10.py``,
after the reference's ``scripts/cifar10.py:24-62``).

The reference recipe: the CCT global model (``--model cct`` is CCT-2,
``cct_2_3x2_32``, D = 283,723), 20 clients of which 8 are Byzantine,
local steps with a client-side Adam whose state persists across rounds,
MultiStepLR milestones [150, 300, 500] with gamma 0.5. Run from a
directory holding CIFAR-10's python batches under ``./data``::

    python -m blades_tpu_torch.examples.cifar10 --agg trimmedmean --attack alie
    python -m blades_tpu_torch.examples.cifar10 --synthetic --device cpu \\
        --num_clients 4 --num_byzantine 1 --global_round 1 --local_round 1

``--synthetic`` uses the offline stand-in dataset; ``--device cpu`` runs on
the CPU (the default is the card). The flags are ``args.py``'s; the run's
log goes to its ``log_dir``, ``outputs/<dataset>/<encoding>``. With
``--agg trimmedmean`` the card's trimmed-mean kernel runs once a round,
with b = ``--num_byzantine``.
"""

from __future__ import annotations

from typing import List, Optional

from blades_tpu_torch.core import ClientOptSpec
from blades_tpu_torch.datasets import CIFAR10, Synthetic
from blades_tpu_torch.examples.args import parse_arguments
from blades_tpu_torch.simulator import Simulator
from blades_tpu_torch.utils.platform import apply_numerics


def main(argv: Optional[List[str]] = None) -> Simulator:
    apply_numerics()
    options = parse_arguments(argv)
    if options.synthetic:
        dataset = Synthetic(
            num_classes=10,
            sample_shape=(32, 32, 3),
            train_size=256 * options.num_clients,
            num_clients=options.num_clients,
            iid=not options.noniid,
            alpha=options.alpha,
            seed=options.seed,
            train_bs=options.batch_size,
        )
    else:
        dataset = CIFAR10(
            data_root="./data",
            train_bs=options.batch_size,
            num_clients=options.num_clients,
            iid=not options.noniid,
            alpha=options.alpha,
            seed=options.seed,
        )

    simulator = Simulator(
        dataset=dataset,
        aggregator=options.agg,
        aggregator_kws=options.agg_args.get(options.agg, {}),
        num_byzantine=options.num_byzantine,
        attack=options.attack,
        attack_kws=options.attack_args.get(options.attack, {}),
        log_path=options.log_dir,
        seed=options.seed,
        device=options.device,
    )

    simulator.run(
        model=options.model,
        server_optimizer="SGD",
        # the reference's torch.optim.Adam on the clients (cifar10.py:45)
        client_optimizer=ClientOptSpec(name="adam", persist=True),
        loss="crossentropy",
        global_rounds=options.global_round,
        local_steps=options.local_round,
        validate_interval=options.log_interval,
        test_batch_size=options.test_batch_size,
        server_lr=1.0,
        client_lr=options.lr,
        # the reference's MultiStepLR: milestones [150, 300, 500], gamma 0.5
        client_lr_scheduler={"milestones": [150, 300, 500], "gamma": 0.5},
        train_batch_size=options.batch_size,
    )
    return simulator


if __name__ == "__main__":
    main()
