"""One process of a multi-process federated round, and the harness that
runs a localhost job of them.

Counterpart: ``blades_tpu/parallel/_dist_worker.py:1-242`` (``make_data``
:30-36, ``run_round`` :39-65, ``run_local_cluster`` :68-168, ``main``
:171-238). Each process:

1. joins the job through :func:`blades_tpu_torch.parallel.distributed.initialize`
   (the explicit-coordinator path a real job takes), on ``--backend``
   (``gloo`` on the CPU, ``nccl`` on the card: a one-card machine runs one
   rank, as NCCL refuses two ranks on one device);
2. builds the global (clients, model) mesh over every rank's
   ``--local-devices`` entries of ``--device``;
3. holds ONLY its own clients' rows (``host_client_slice``,
   ``make_global_client_array``); with ``--placed`` it builds the round's
   batches from a client store instead (:func:`make_store`), placed on the
   job mesh (``FLDataset.place``: the store keeps only this process's
   rows) and sampled from the generator of :data:`SEED` on every rank;
4. runs one round of the MLP (local SGD, IPM, the trimmed mean, the server
   step) through the round engine's multi-process path, from the params
   in ``--params`` (an ``.npz`` whose ``flat`` is the JAX package's init in
   its flat order, read through the port's weight map) or the port's own
   init of seed 0;
5. prints one ``DIST_RESULT`` JSON line. On the card the trimmed mean's
   kernel launches, and each launch is held against the plain version
   (``launches``, ``max_abs_err``).

Run as::

    python -m blades_tpu_torch.parallel._dist_worker <process_id> \\
        <num_processes> <coordinator_port> [--backend gloo] [--device cpu] \\
        [--local-devices 4] [--params init.npz] [--placed]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: the round's learning rates and seed (JAX :62-64: 0.1, 1.0, key 3)
CLIENT_LR, SERVER_LR, SEED = 0.1, 1.0, 3


def make_data(num_clients: int, local_steps: int, batch: int):
    """Deterministic synthetic MNIST-shaped client data: every process
    makes the same global arrays and keeps its own rows."""
    rng = np.random.RandomState(42)
    cx = rng.randn(num_clients, local_steps, batch, 28, 28, 1).astype(np.float32)
    cy = rng.randint(0, 10, (num_clients, local_steps, batch)).astype(np.int32)
    return cx, cy


#: the client store of --placed: samples per client (the counts are
#: ragged, so the sampler pads and wraps around)
STORE_SAMPLES = 8


def make_store(num_clients: int, device="cpu"):
    """A deterministic MNIST-shaped ``FLDataset`` of ``num_clients``
    clients with ragged counts: every process makes the same store (and
    ``place`` keeps its own rows)."""
    from blades_tpu_torch.datasets.fl import FLDataset

    rng = np.random.RandomState(42)
    x = rng.randn(num_clients, STORE_SAMPLES, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, (num_clients, STORE_SAMPLES)).astype(np.int32)
    counts = rng.randint(STORE_SAMPLES // 2, STORE_SAMPLES + 1, num_clients)
    return FLDataset(x, y, counts, x[:, 0], y[:, 0], device=device)


def sample_store(fl, local_steps: int, batch: int):
    """One round's batches of the store ``fl`` from the generator of
    :data:`SEED` on its (primary) device."""
    import torch

    gen = torch.Generator(device=fl.device).manual_seed(SEED)
    return fl.sample_round(gen, local_steps, batch)


def initial_params(spec, flat=None):
    """The round's start params: ``flat`` (the JAX package's flat order)
    through the weight map, else the port's init of seed 0."""
    import torch

    from blades_tpu_torch.ops.pytree import make_unraveler

    template = spec.init(torch.Generator().manual_seed(0))
    if flat is None:
        return template
    _, unravel = make_unraveler(template, spec.layout)
    flat = torch.as_tensor(np.array(flat, np.float32))
    return {n: t.clone() for n, t in unravel(flat).items()}


def run_round(plan, num_clients: int, cx, cy, num_byzantine: int, flat=None):
    """Build the round engine over ``plan`` and run one round:
    ``(new state, metrics, engine)``."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.attackers import get_attack
    from blades_tpu_torch.core import ClientOptSpec, RoundEngine, ServerOptSpec
    from blades_tpu_torch.models import create_mnist_model

    spec = create_mnist_model()
    params = initial_params(spec, flat)
    engine = RoundEngine(
        spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
        num_clients=num_clients, num_byzantine=num_byzantine, attack=get_attack("ipm"),
        aggregator=get_aggregator("trimmedmean", num_byzantine=num_byzantine),
        client_opt=ClientOptSpec(), server_opt=ServerOptSpec(), num_classes=10,
        keep_updates=False, plan=plan,
    )
    state, metrics = engine.run_round(engine.init(params), cx, cy, CLIENT_LR, SERVER_LR, SEED)
    return state, metrics, engine


def round_summary(state, metrics, engine) -> dict:
    """The round's numbers a process reports: the two metrics of JAX's
    ``DIST_RESULT`` and the new params' sum and norm (float64)."""
    import torch

    from blades_tpu_torch.ops.pytree import ravel

    flat = ravel(state.params, engine.layout).detach().to("cpu", torch.float64)
    return {"train_loss": float(metrics.train_loss), "agg_norm": float(metrics.agg_norm),
            "params_sum": float(flat.sum()), "params_norm": float(flat.norm())}


def run_local_cluster(
    n_processes: int = 2,
    devices_per_process: int = 4,
    timeout: float = 900.0,
    backend: str = "gloo",
    device: str = "cpu",
    params_path=None,
    placed: bool = False,
    _fault_injector=None,
):
    """Spawn ``n_processes`` workers joined into one localhost job and
    collect their ``DIST_RESULT`` rows: ``{process_id: result}``.

    The failure handling of the JAX harness (:80-103):

    - output goes to temporary FILES, never pipes (a full pipe would block a
      worker before the barrier and hang the job into a slow timeout);
    - the workers are polled concurrently, and the first nonzero exit tears
      the job down at once and raises with that worker's stderr tail;
    - every worker is always reaped.

    ``_fault_injector(procs)``: a test hook called once right after the
    spawn (the failure test kills a worker). ``placed``: the workers sample
    their batches from a placed store (``--placed``). Raises RuntimeError
    on any worker's failure or timeout."""
    import os
    import socket
    import subprocess
    import tempfile
    import time

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    # one torch thread per worker unless the caller sets another count
    env.setdefault("OMP_NUM_THREADS", "1")
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    extra = ["--backend", backend, "--device", device,
             "--local-devices", str(devices_per_process)]
    if params_path is not None:
        extra += ["--params", str(params_path)]
    if placed:
        extra.append("--placed")
    results = {}
    with tempfile.TemporaryDirectory(prefix="blades_torch_dist_") as tmp:
        outs, errs, procs = [], [], []
        try:
            for pid in range(n_processes):
                fo = open(os.path.join(tmp, f"out{pid}"), "w+")
                fe = open(os.path.join(tmp, f"err{pid}"), "w+")
                outs.append(fo)
                errs.append(fe)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "blades_tpu_torch.parallel._dist_worker",
                     str(pid), str(n_processes), str(port), *extra],
                    stdout=fo, stderr=fe, text=True, env=env, cwd=repo,
                ))
            if _fault_injector is not None:
                _fault_injector(procs)
            deadline = time.time() + timeout
            pending = dict(enumerate(procs))
            while pending:
                for pid in sorted(pending):
                    rc = pending[pid].poll()
                    if rc is None:
                        continue
                    del pending[pid]
                    if rc != 0:
                        errs[pid].flush()
                        errs[pid].seek(0)
                        tail = errs[pid].read()[-2000:]
                        raise RuntimeError(
                            f"worker {pid} failed (rc={rc}); tearing down "
                            f"the remaining {len(pending)} worker(s):\n{tail}"
                        )
                if pending and time.time() > deadline:
                    raise RuntimeError(f"workers {sorted(pending)} timed out after {timeout}s")
                if pending:
                    time.sleep(0.2)
            for pid, fo in enumerate(outs):
                fo.flush()
                fo.seek(0)
                for line in fo.read().splitlines():
                    if line.startswith("DIST_RESULT "):
                        results[pid] = json.loads(line[len("DIST_RESULT "):])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in outs + errs:
                f.close()
    missing = set(range(n_processes)) - set(results)
    if missing:
        raise RuntimeError(f"no DIST_RESULT from workers {sorted(missing)}")
    return results


class _Held:
    """Every launch of the trimmed mean's kernel in this process, its
    output held against the plain version on the same input."""

    def __init__(self, trimmed):
        self.trimmed, self.launches, self.max_abs_err = trimmed, 0, 0.0
        self._orig = trimmed.trimmed_mean_cuda
        trimmed.trimmed_mean_cuda = self

    def __call__(self, updates, b):
        out = self._orig(updates, b)
        plain = self.trimmed.trimmed_mean_plain(updates, b)
        self.launches += 1
        self.max_abs_err = max(self.max_abs_err, float((out - plain).abs().max()))
        return out

    def close(self):
        self.trimmed.trimmed_mean_cuda = self._orig


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="one process of a multi-process round")
    parser.add_argument("pid", type=int)
    parser.add_argument("nproc", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--local-devices", type=int, default=4)
    parser.add_argument("--params", default=None, help=".npz with the flat init 'flat'")
    parser.add_argument("--placed", action="store_true",
                        help="sample the batches from a client store placed on the mesh")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from blades_tpu_torch.ops import trimmed
    from blades_tpu_torch.parallel import distributed as dist
    from blades_tpu_torch.parallel.mesh import make_plan

    device = torch.device(args.device)
    if dist.backend_for(device) != args.backend:
        raise SystemExit(f"--backend {args.backend} does not serve --device {device}")
    dist.initialize(f"127.0.0.1:{args.port}", args.nproc, args.pid, device=device)
    world = dist.world_size()
    assert world == args.nproc, f"expected {args.nproc} processes, the group has {world}"
    mesh = dist.make_global_mesh(local_devices=[device] * args.local_devices)
    plan = make_plan(mesh)

    num_clients = 2 * mesh.size
    local_steps, batch = 2, 4
    lo, hi = dist.host_client_slice(num_clients, mesh)
    store = {}
    if args.placed:
        fl = make_store(num_clients, plan.primary).place(plan)
        cx, cy = sample_store(fl, local_steps, batch)
        store = {"placed": fl.placed, "store_rows": [fl.train_x.lo, fl.train_x.hi],
                 "store_pieces": [int(p.shape[0]) for p in fl.train_x.pieces],
                 "batch_rows": [cx.lo, cx.hi]}
        del fl
    else:
        cx_full, cy_full = make_data(num_clients, local_steps, batch)
        # only this process's rows are kept
        cx = dist.make_global_client_array(cx_full[lo:hi], num_clients, plan)
        cy = dist.make_global_client_array(cy_full[lo:hi], num_clients, plan)
    flat = np.load(args.params)["flat"] if args.params else None

    held = _Held(trimmed) if device.type == "cuda" else None
    try:
        state, metrics, engine = run_round(plan, num_clients, cx, cy, num_clients // 4, flat)
        summary = round_summary(state, metrics, engine)
    finally:
        if held is not None:
            held.close()
    dist.sync_global_devices("round-done")
    print("DIST_RESULT " + json.dumps({
        "process": args.pid,
        "num_processes": world,
        "backend": args.backend,
        "device": str(device),
        "local_devices": args.local_devices,
        "global_devices": mesh.size,
        "client_slice": [lo, hi],
        "is_coordinator": dist.is_coordinator(),
        **store,
        **summary,
        **({"launches": held.launches, "max_abs_err": held.max_abs_err} if held else {}),
    }), flush=True)
    dist.shutdown()


if __name__ == "__main__":
    main()
