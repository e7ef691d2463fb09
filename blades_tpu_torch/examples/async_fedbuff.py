"""Buffered-asynchronous rounds (FedBuff): arrivals, staleness, fires
(counterpart: ``examples/async_fedbuff.py``).

Federated clients do not report in lockstep: they download the model,
train for as long as their hardware takes, and report late. This demo runs
``blades_tpu_torch/asyncfl``'s buffered-async semantics end to end:

1. **degenerate equivalence**: ``buffer_m = K``, zero-delay arrivals and
   constant weighting give the synchronous run's final parameters bit for
   bit (the invariant that anchors the async body to the sync engine);
2. **a staggered federation**: uniform arrival delays, a first-M fire
   threshold, polynomial staleness weighting, 2 byzantine IPM clients under
   a median defense; the per-round ``async`` telemetry records (arrivals,
   buffer fill, fire flag, staleness moments) read back from the trace and
   printed as a timeline;
3. **staleness modes**: the same scenario under constant, polynomial and
   cutoff weighting, with fire cadence and final loss.

The reference's simulator is strictly synchronous
(``src/blades/simulator.py:203-247``). Protocol: FedBuff (Nguyen et al.,
AISTATS 2022).

    python -m blades_tpu_torch.examples.async_fedbuff [--rounds 6] [--device cpu]

Outputs under ``--out`` (``results/async_demo_torch/`` by default,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "async_demo_torch"


def async_records(log_path):
    """Per-round ``async`` records from the run's telemetry trace."""
    trace = os.path.join(log_path, "telemetry.jsonl")
    if not os.path.exists(trace):  # BLADES_TELEMETRY=0
        return []
    with open(trace) as f:
        return [r for r in map(json.loads, f) if r.get("t") == "async"]


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    p = argparse.ArgumentParser(description="buffered-asynchronous (FedBuff) rounds")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    import numpy as np

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.ops.pytree import ravel

    def build(sub, seed=5):
        return Simulator(
            dataset=Synthetic(num_clients=8, train_size=800, test_size=160, noise=0.3,
                              cache=False),
            aggregator="median",
            attack="ipm",
            num_byzantine=2,
            log_path=os.path.join(args.out, sub),
            seed=seed,
            device=args.device,
        )

    def flat(sim):
        return ravel(sim.server.state.params, sim.engine.layout).detach().cpu().numpy()

    run_kw = dict(global_rounds=args.rounds, local_steps=1, client_lr=0.2, server_lr=1.0,
                  train_batch_size=8, validate_interval=args.rounds)

    # -- 1. degenerate equivalence: async(buffer_m=K, zero delay) == sync ---
    sync = build("sync")
    sync.run("mlp", **run_kw)
    degen = build("degenerate")
    degen.run("mlp", async_config=dict(buffer_m=8, arrivals=dict(kind="zero"),
                                       staleness="constant"), **run_kw)
    report = {"degenerate_bit_exact": bool(np.array_equal(flat(sync), flat(degen)))}
    assert report["degenerate_bit_exact"], "degenerate async != sync!"
    print("degenerate async (buffer_m=K, zero delays, constant) == sync: "
          "final params bit-identical\n")

    # -- 2. staggered arrivals and polynomial staleness weighting ------------
    asy = build("fedbuff")
    asy.run("mlp", async_config=dict(buffer_m=4, arrivals=dict(kind="uniform", max_delay=2),
                                     staleness="polynomial", alpha=0.5), **run_kw)
    ev = asy.evaluate(args.rounds, 64)
    assert np.isfinite(ev["Loss"]), "async run went non-finite!"
    print(f"fedbuff(m=4, uniform delays<=2, poly a=0.5)  "
          f"loss={ev['Loss']:.4f} top1={ev['top1']:.3f}")
    print("tick  arrivals  buffer  fired  aggregated  mean_tau")
    recs = async_records(os.path.join(args.out, "fedbuff"))
    for r in recs:
        print(f"{r['round']:4d}  {r['arrivals']:8d}  {r['buffer_count']:6d}"
              f"  {r['fired']:5d}  {r['aggregated']:10d}"
              f"  {r['mean_staleness']:8.2f}")
    fires = sum(r["fired"] for r in recs)
    print(f"fires: {fires}/{args.rounds} ticks\n")
    report["fedbuff"] = {"loss": float(ev["Loss"]), "top1": float(ev["top1"]), "fires": fires,
                         "ticks": len(recs)}

    # -- 3. staleness modes ---------------------------------------------------
    modes = [
        ("constant", dict(staleness="constant")),
        ("polynomial", dict(staleness="polynomial", alpha=0.5)),
        ("cutoff", dict(staleness="cutoff", cutoff=1)),
    ]
    report["modes"] = {}
    for name, stale_kw in modes:
        sim = build(f"mode_{name}")
        sim.run("mlp", async_config=dict(buffer_m=4, arrivals=dict(kind="uniform",
                                                                   max_delay=2),
                                         **stale_kw), **run_kw)
        ev = sim.evaluate(args.rounds, 64)
        recs = async_records(os.path.join(args.out, f"mode_{name}"))
        fires = sum(r["fired"] for r in recs)
        excluded = sum(r["stale_excluded"] for r in recs)
        report["modes"][name] = {"loss": float(ev["Loss"]), "fires": fires,
                                 "stale_excluded": excluded}
        print(f"{name:10s} loss={ev['Loss']:.4f} fires={fires} stale_excluded={excluded}")
    return report


if __name__ == "__main__":
    main()
