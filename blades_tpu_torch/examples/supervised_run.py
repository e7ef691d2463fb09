"""Run supervision end to end: a hung run is killed by its heartbeat and
resumed bit for bit.

Counterpart: ``examples/supervised_run.py``. A hang raises nothing (a stuck
collective, a card that stopped answering); the run supervisor
(``supervision/supervisor.py``) makes it a bounded, recorded recovery:

1. a reference run finishes uninterrupted, and its final parameters are
   saved;
2. the same run is launched under the supervisor with a saboteur that
   hangs it at a round, after spawning a grandchild. ``Simulator.run``
   beats a heartbeat at every round's flush; the beat goes stale, the
   supervisor kills the run's whole process group (SIGTERM, on which the
   crash autosave fires, then SIGKILL; no process left), and relaunches it
   with ``BLADES_RESUME=1``;
3. the relaunch resumes from the autosave and finishes, its final
   parameters equal to the reference's bit for bit, the launch, kill,
   retry and resume in the run's own ``telemetry.jsonl``.

Usage::

    python -m blades_tpu_torch.examples.supervised_run [--device cpu] [--rounds 3]

``--child`` is the supervised workload itself. ``--workload mlp`` (the
default) is the JAX example's small MLP federation, with the median.
``--workload cct2`` is CCT-2 (D = 283,723) at K=1000 clients on
CIFAR-shaped synthetic data in 4 client chunks, bf16 compute, ALIE f=5
against trimmed mean b=5: the round that launches the trimmed-mean kernel
once a round on the card. A child sets cuDNN's deterministic algorithms
and turns TF32 off, so a relaunch in another process computes what the
reference computed. With ``--timings F`` a child appends what it did, with
timestamps, to ``F`` (one JSON line an event: its start, imports, CUDA
start, kernel load, data, the run's start, each round's end with the
kernel's launches so far and, on the card, the largest difference of the
kernel from its plain version on the round's own update matrix, and the
end), for the time-to-recover split.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the workloads: dataset, simulator and run arguments
WORKLOADS = {
    "mlp": dict(
        dataset=dict(num_clients=6, train_size=300, test_size=60, noise=0.3),
        sim=dict(aggregator="median", seed=7),
        run=dict(model="mlp", local_steps=1, train_batch_size=8, client_lr=0.2,
                 server_lr=1.0),
    ),
    "cct2": dict(
        dataset=dict(num_clients=1000, sample_shape=(32, 32, 3), train_bs=32,
                     train_size=32_000, test_size=2_000),
        sim=dict(attack="alie", num_byzantine=5, aggregator="trimmedmean",
                 aggregator_kws={"num_byzantine": 5}, seed=1),
        run=dict(model="cct_2_3x2_32", local_steps=1, client_lr=0.1, server_lr=1.0,
                 client_chunks=4, compute_dtype="bfloat16"),
    ),
}


class _Timings:
    """The child's event log (``--timings``): one JSON line an event."""

    def __init__(self, path):
        self.path = path

    def __call__(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"event": event, "ts": time.time(), "pid": os.getpid(),
               "attempt": int(os.environ.get("BLADES_ATTEMPT", "1")), **fields}
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


def child_main(args) -> None:
    """The supervised workload: a run with a checkpoint every round that
    hangs at ``--hang-at`` once (a sentinel beside ``--out`` disarms it for
    the relaunch)."""
    note = _Timings(args.timings)
    note("start")
    import torch

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.ops import _build, trimmed
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.telemetry.recorder import process_counters
    from blades_tpu_torch.utils.platform import apply_numerics

    note("imports")
    apply_numerics()
    on_card = args.device != "cpu"
    if on_card:
        torch.cuda.init()
        torch.cuda.synchronize()
        note("cuda")
        _build.load("trimmed_mean")
        note("kernel", counters=process_counters())

    spec = WORKLOADS[args.workload]
    sentinel = os.path.normpath(args.out) + ".hang_fired"
    # a fresh launch (not a supervised relaunch) clears an earlier run's
    # sentinel, or the hang would never fire
    if os.environ.get("BLADES_RESUME") != "1" and os.path.exists(sentinel):
        os.unlink(sentinel)
    sim = Simulator(dataset=Synthetic(cache=False, **spec["dataset"]), log_path=args.out,
                    device=args.device, **spec["sim"])
    note("data")
    b = spec["sim"].get("aggregator_kws", {}).get("num_byzantine")

    def on_round_end(rnd, state, m):
        fields = {"launches": trimmed.trimmed_mean_launches}
        if on_card and b is not None:
            # the kernel against its plain version on this round's own
            # update matrix; these launches are not the round's
            u = sim.engine.last_updates
            got = trimmed.trimmed_mean_cuda(u, b)
            ref = trimmed.trimmed_mean_plain(u, b)
            fields.update(max_abs_err=float((got - ref).abs().max()),
                          kernel_ok=bool(torch.allclose(got, ref, rtol=1e-5, atol=1e-5)))
            trimmed.trimmed_mean_launches = fields["launches"]
            del got, ref, u
        note("round", round=rnd, **fields)
        if args.hang_at and rnd == args.hang_at and not os.path.exists(sentinel):
            open(sentinel, "w").close()
            subprocess.Popen(["sleep", "600"])  # a grandchild for the group kill
            note("hang", round=rnd)
            print(f"[child] hanging at round {rnd}", flush=True)
            time.sleep(600)

    trimmed.trimmed_mean_launches = 0
    note("run")
    sim.run(global_rounds=args.rounds, validate_interval=args.rounds,
            checkpoint_path=os.path.join(args.out, "ck"), checkpoint_interval=1,
            on_round_end=on_round_end, **spec["run"])
    params = ravel(sim.server.state.params, sim.engine.layout).detach().cpu()
    torch.save(params, args.params_out)
    note("done", launches=trimmed.trimmed_mean_launches, counters=process_counters())
    print("[child] run complete", flush=True)


def child_cmd(args, out: str, params: str, hang: int, timings=None) -> list:
    """The argv of one child run."""
    cmd = [sys.executable, "-m", "blades_tpu_torch.examples.supervised_run", "--child",
           "--workload", args.workload, "--device", args.device, "--rounds", str(args.rounds),
           "--out", out, "--params-out", params, "--hang-at", str(hang)]
    return cmd + (["--timings", timings] if timings else [])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default=os.path.join(REPO, "results", "supervised_demo_torch"))
    p.add_argument("--workload", choices=sorted(WORKLOADS), default="mlp")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--child", action="store_true")
    p.add_argument("--hang-at", type=int, default=0)
    p.add_argument("--params-out", default=None)
    p.add_argument("--timings", default=None)
    args = p.parse_args(argv)
    if args.child:
        child_main(args)
        return 0

    import torch

    from blades_tpu_torch.supervision import Supervisor

    env = {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    hang_round = max(args.rounds - 1, 1)
    os.makedirs(args.out, exist_ok=True)

    # 1. the uninterrupted reference
    ref_params = os.path.join(args.out, "ref_params.pt")
    subprocess.run(child_cmd(args, os.path.join(args.out, "ref"), ref_params, 0),
                   check=True, env=dict(os.environ, **env))

    # 2. the supervised run, hung once
    sup_dir = os.path.join(args.out, "supervised")
    sup_params = os.path.join(args.out, "sup_params.pt")
    telemetry = os.path.join(sup_dir, "telemetry.jsonl")
    if os.path.exists(telemetry):
        os.unlink(telemetry)  # a fresh demonstration starts its trail anew
    result = Supervisor(
        child_cmd(args, sup_dir, sup_params, hang_round),
        # above one round, its checkpoint's save and the evaluation
        heartbeat_timeout_s=10.0,
        startup_grace_s=600.0,  # imports, CUDA's start, a cold kernel build
        attempts=2, term_grace_s=30.0, telemetry_path=telemetry, env=env,
    ).run()

    print("\nattempt trail:")
    for a in result.attempts:
        print(f"  attempt {a.index}: {a.reason:16s} degrade={list(a.degrade) or '-'} "
              f"resumed={a.resumed} orphans={len(a.survivors)}")
    if not (result.ok and result.attempts[0].reason == "heartbeat_stale"
            and result.attempts[0].survivors == ()):
        print("supervised run did not recover as expected", file=sys.stderr)
        return 1
    exact = torch.equal(torch.load(ref_params), torch.load(sup_params))
    print(f"resumed run's final params bit-identical to the uninterrupted run's: {exact}")
    with open(telemetry) as f:
        events = [r["event"] for r in map(json.loads, f) if r.get("t") == "supervisor"]
    print("supervisor trail:", events)
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
