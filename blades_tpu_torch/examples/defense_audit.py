"""Defense certification and the runtime audit: search, certify, fall back
(counterpart: ``examples/defense_audit.py``).

The paper's claim is not that runs survive but that the *defenses* are
Byzantine-robust. This demo exercises the audit (``blades_tpu_torch/audit``)
that measures and reacts to a defense's breakdown:

1. **offline certification**: the adaptive attack search (IPM/ALIE/
   sign-flip sweeps + min-max/min-sum bisection, NDSS'21 style) runs over
   a few defenses at their nominal f: the robust ones stay within
   ``c = 3`` honest spreads of the honest mean; plain ``mean`` is dragged
   orders of magnitude away (breakdown point 0);
2. **runtime audit + fallback**: a federation aggregating with ``mean``
   under a strong IPM attack, with the runtime monitor's median-ball /
   envelope certificates inside the round: every breached round swaps in
   the ``median`` fallback by ``torch.where``, the model converges anyway,
   and per-round ``audit`` telemetry records the forensics;
3. the breach->fallback run is **bit-reproducible**: rerunning the same
   seed reproduces the final parameters exactly (``torch.equal``).

The honest trials come from a ``torch.Generator`` at seed 0 (the JAX
example's ``jax.random.PRNGKey(0)``). None of the four defenses nor the
fallback is the trimmed mean: no kernel launch.

    python -m blades_tpu_torch.examples.defense_audit [--rounds 4] [--out DIR] [--device cpu]

Outputs under ``--out`` (``results/audit_demo_torch/`` by default,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Optional

from blades_tpu_torch.examples.convergence_config1 import REPO
from blades_tpu_torch.utils.platform import apply_numerics

DEFAULT_OUT = REPO / "results" / "audit_demo_torch"

#: the defenses certified in part 1
DEFENSES = ("mean", "median", "krum", "centeredclipping")


def main(argv: Optional[List[str]] = None) -> dict:
    """The three parts; returns each defense's cell and verdict, the audit
    records, the final evaluation and whether the rerun was bit for bit."""
    apply_numerics()
    p = argparse.ArgumentParser(description="defense certification and the runtime audit")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--out", default=str(DEFAULT_OUT))
    p.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = p.parse_args(argv)

    import torch

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.audit import (
        QUICK_GRIDS,
        battery_ctx,
        battery_kwargs,
        nominal_f,
        search_cell,
        synthetic_honest,
    )
    from blades_tpu_torch.core.engine import resolve_device
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.ops.pytree import ravel

    device = resolve_device(args.device)

    # -- 1. offline certification: worst-case deviation per defense ---------
    K, D = 8, 32
    trials = synthetic_honest(torch.Generator().manual_seed(0), 2, K, D, device=device)
    ctx = battery_ctx(None, K, D, device=device)
    print(f"adaptive attack search, K={K}, worst deviation / honest spread "
          f"(certified iff <= 3):")
    cells = {}
    for name in DEFENSES:
        f = max(1, nominal_f(name, K))
        agg = get_aggregator(name, **battery_kwargs(name, K, f))
        cell = search_cell(agg, trials, f, ctx=ctx, grids=QUICK_GRIDS)
        verdict = "CERTIFIED" if cell["worst_ratio"] <= 3.0 else "BREAKS"
        cells[name] = {"f": f, "worst_ratio": cell["worst_ratio"], "verdict": verdict}
        print(f"  {name:18s} f={f}  worst_ratio={cell['worst_ratio']:8.2f}  "
              f"{verdict}")

    # -- 2. runtime audit: mean under IPM, certified fallback to median -----
    def build(sub, seed=7):
        return Simulator(
            dataset=Synthetic(num_clients=K, train_size=800, test_size=160,
                              noise=0.3, cache=False),
            aggregator="mean",
            attack="ipm", attack_kws={"epsilon": 50.0}, num_byzantine=2,
            log_path=os.path.join(args.out, sub), seed=seed, device=args.device,
        )

    run_kw = dict(global_rounds=args.rounds, local_steps=2, client_lr=0.2,
                  server_lr=1.0, train_batch_size=8,
                  validate_interval=args.rounds,
                  audit_monitor=dict(fallback_aggregator="median"))

    sim = build("audited")
    sim.run("mlp", **run_kw)
    ev = sim.evaluate(args.rounds, 64)
    assert math.isfinite(ev["Loss"]), "audited run went non-finite!"

    trace = os.path.join(args.out, "audited", "telemetry.jsonl")
    audits = []
    if os.path.exists(trace):  # BLADES_TELEMETRY=0 disables the trace
        with open(trace) as f:
            audits = [r for r in map(json.loads, f) if r.get("t") == "audit"]
    print(f"\nmean + IPM(eps=50), 2/{K} byzantine, fallback=median:")
    for r in audits:
        print(f"  round {r['round']}: breach={r['breach']} "
              f"fallback_used={r['fallback_used']} "
              f"dev_honest(raw)={r['dev_honest_raw']:.3f} "
              f"dev_honest(applied)={r['dev_honest']:.3f} "
              f"(honest spread {r['max_honest_dev']:.3f})")
    print(f"final eval: loss={ev['Loss']:.4f} top1={ev['top1']:.3f}")
    if audits:
        assert all(r["fallback_used"] == r["breach"] for r in audits)
        assert any(r["breach"] for r in audits), "IPM never breached?"

    # -- 3. breach->fallback rounds are bit-reproducible ---------------------
    again = build("audited_rerun")
    again.run("mlp", **run_kw)
    a = ravel(sim.server.state.params, sim.engine.layout)
    b = ravel(again.server.state.params, again.engine.layout)
    exact = bool(torch.equal(a, b))
    print(f"breach->fallback run bit-reproducible under the same seed: {exact}")
    assert exact
    return {"cells": cells, "audits": audits, "final_eval": ev, "bit_reproducible": exact}


if __name__ == "__main__":
    main()
