"""The reference CLI's flags (counterpart: ``scripts/args.py``, after
the reference's ``scripts/args.py:7-68``).

The same flags and defaults, the same per-attack and per-aggregator keyword
dicts (``attack_args``, ``agg_args``) and the same config-encoding name of
the log directory, plus ``--device`` (the card by default, ``cpu`` when
asked). ``--use-cuda``, ``--num_actors`` and ``--num_gpus`` are accepted
for compatibility and ignored: the device is ``--device``.

``log_dir`` is ``outputs/<dataset>/<encoding>`` under the working directory
(``outputs/`` is git-ignored); the encoding, its last component, is the
JAX package's letter for letter.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def parse_arguments(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--global_round", type=int, default=400)
    parser.add_argument("--local_round", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--test_batch_size", type=int, default=128)
    parser.add_argument("--log_interval", type=int, default=10)
    parser.add_argument("--attack", type=str, default="signflipping",
                        help="Select attack types.")
    parser.add_argument("--dataset", type=str, default="cifar10")
    parser.add_argument("--model", type=str, default="cct")
    parser.add_argument("--agg", type=str, default="clippedclustering",
                        help="Aggregator.")
    parser.add_argument("--lr", type=float, default=0.1, help="learning rate")
    parser.add_argument("--num_clients", type=int, default=20)
    parser.add_argument("--num_byzantine", type=int, default=8)
    parser.add_argument("--noniid", action="store_true", default=False)
    parser.add_argument("--alpha", type=float, default=0.1,
                        help="Dirichlet concentration for non-IID partition")
    parser.add_argument("--synthetic", action="store_true", default=False,
                        help="use the offline synthetic dataset")
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (the default)")
    # accepted for compatibility and ignored: the device is --device
    parser.add_argument("--use-cuda", action="store_true", default=False)
    parser.add_argument("--num_actors", type=int, default=20)
    parser.add_argument("--num_gpus", type=int, default=0)
    options = parser.parse_args(argv)

    options.attack_args = {
        "noise": {},
        "labelflipping": {},
        "signflipping": {},
        "alie": {},
        "ipm": {"epsilon": 0.5},
        "minmax": {},
        "minsum": {},
    }
    options.agg_args = {
        "mean": {},
        "median": {},
        "trimmedmean": {"num_byzantine": options.num_byzantine},
        "krum": {"num_byzantine": options.num_byzantine},
        "multikrum": {"num_byzantine": options.num_byzantine},
        "geomed": {},
        "autogm": {},
        "centeredclipping": {},
        "clustering": {},
        "clippedclustering": {},
        "dnc": {"num_byzantine": options.num_byzantine},
        "signguard": {},
        "fltrust": {},
        "byzantinesgd": {},
    }

    attack_kw = options.attack_args.get(options.attack, {})
    agg_kw = options.agg_args.get(options.agg, {})
    encoding = (
        f"b{options.num_byzantine}"
        + f"_{options.attack}"
        + ("_" + "_".join(k + str(v) for k, v in attack_kw.items()) if attack_kw else "")
        + f"_{options.agg}"
        + ("_" + "_".join(k + str(v) for k, v in agg_kw.items()) if agg_kw else "")
        + f"_lr{options.lr}"
        + f"_bz{options.batch_size}"
        + f"_seed{options.seed}"
    )
    options.log_dir = os.path.join("outputs", options.dataset, encoding)
    return options
