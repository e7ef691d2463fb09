"""Multi-process federated training (counterpart:
``examples/multihost_pod.py``).

The reference scales out by deploying a Ray cluster and shipping client
objects to actor processes (``README.rst:146-149``, ``simulator.py:90-98``).
Here every process of the job runs THIS SAME script:
``parallel/distributed.py:initialize`` joins them into one
``torch.distributed`` group from the launcher's environment (torchrun's
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), each
process holds only its own clients' rows, and the round engine gathers the
``[K, D]`` matrix on every rank (``core/engine.py``, the multi-process
round). The backend follows ``--device``: NCCL on the card (one rank per
card: NCCL refuses two ranks on one device), gloo on the CPU. Without a
job in the environment it runs as one process.

    torchrun --nproc-per-node 2 -m blades_tpu_torch.examples.multihost_pod
    python -m blades_tpu_torch.examples.multihost_pod --device cpu

Knobs (environment, as in the JAX example): ``POD_CLIENTS`` (K, default
1024), ``POD_STEPS`` (local steps, 2), ``POD_BATCH`` (32), ``POD_ROUNDS``
(10), ``POD_SAMPLES`` (samples a client, 64).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from blades_tpu_torch.utils.platform import apply_numerics

K = int(os.environ.get("POD_CLIENTS", 1024))
LOCAL_STEPS = int(os.environ.get("POD_STEPS", 2))
BATCH = int(os.environ.get("POD_BATCH", 32))
ROUNDS = int(os.environ.get("POD_ROUNDS", 10))
SAMPLES_PER_CLIENT = int(os.environ.get("POD_SAMPLES", 64))


def main(argv: Optional[List[str]] = None) -> list:
    apply_numerics()
    ap = argparse.ArgumentParser(description="multi-process federated CCT-2 training")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = ap.parse_args(argv)

    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.core import ClientOptSpec, RoundEngine, ServerOptSpec
    from blades_tpu_torch.core.engine import resolve_device
    from blades_tpu_torch.datasets.augment import make_normalizer
    from blades_tpu_torch.models import cct_2_3x2_32
    from blades_tpu_torch.models.common import build_fns
    from blades_tpu_torch.parallel import distributed as dist
    from blades_tpu_torch.parallel.mesh import make_plan

    device = resolve_device(args.device)
    dist.initialize(device=device)  # a no-op without a job in the environment
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = dist.make_global_mesh(local_devices=[device])
    plan = make_plan(mesh)
    if dist.is_coordinator():
        print(f"mesh: {mesh}, {dist.world_size()} processes, backend "
              f"{dist.backend_for(device)}")

    # each process holds ONLY its own client rows
    lo, hi = dist.host_client_slice(K, mesh)
    rng = np.random.RandomState(0)
    local_x = rng.randint(0, 256, (hi - lo, SAMPLES_PER_CLIENT, 32, 32, 3),
                          dtype=np.uint8).astype(np.float32)
    local_y = rng.randint(0, 10, (hi - lo, SAMPLES_PER_CLIENT)).astype(np.int32)
    normalize = make_normalizer((0.49, 0.48, 0.44), (0.25, 0.24, 0.26))

    spec = build_fns(cct_2_3x2_32(num_classes=10))
    params = spec.init(torch.Generator().manual_seed(0))
    engine = RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
        num_clients=K, aggregator=get_aggregator("trimmedmean"), client_opt=ClientOptSpec(),
        server_opt=ServerOptSpec(), plan=plan, client_chunks=4, remat=True,
        noise_sites=spec.noise_sites, keep_updates=False,
    )
    state = engine.init(params)
    losses = []
    for r in range(ROUNDS):
        t0 = time.perf_counter()
        # this process's batches, as rows of the global [K, S, B, ...] array
        idx = np.random.RandomState(7 + r).randint(
            0, SAMPLES_PER_CLIENT, (hi - lo, LOCAL_STEPS * BATCH))
        bx = np.take_along_axis(local_x, idx[..., None, None, None], axis=1)
        by = np.take_along_axis(local_y, idx, axis=1)
        bx = normalize(torch.from_numpy(bx)).numpy()
        cx = dist.make_global_client_array(
            bx.reshape(hi - lo, LOCAL_STEPS, BATCH, 32, 32, 3), K, plan)
        cy = dist.make_global_client_array(by.reshape(hi - lo, LOCAL_STEPS, BATCH), K, plan)
        state, m = engine.run_round(state, cx, cy, 0.1, 1.0, seed=7)
        losses.append(float(m.train_loss))  # waits for the round
        if dist.is_coordinator():
            print(f"round {r + 1}: loss={losses[-1]:.4f} ({time.perf_counter() - t0:.2f} s)",
                  flush=True)
    dist.sync_global_devices("done")
    dist.shutdown()
    return losses


if __name__ == "__main__":
    main()
