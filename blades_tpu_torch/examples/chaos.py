"""The seeded chaos suite: reproducible fault weather crossed with the
defense registry, with the robustness invariants checked end to end.

Counterpart: ``scripts/chaos.py`` — ``make_scenario`` (:97) through
``summarize_rows`` (:521), ``child_main`` (:1140) and ``main`` (:1226).
Each scenario is a function of its integer seed alone (numpy draws, the
same scenario as the JAX package's for the same seed): a defense drawn
round-robin from :data:`AGG_POOL`, randomized fault weather (dropout, a
participation schedule, stragglers, NaN, Inf or bit-flip corruption) and
perhaps an attack; every sixth seed runs buffered-async rounds. Checked
for each scenario (:func:`check_invariants`):

1. finite final parameters and evaluation loss (a round with no
   participant is a skip, never a NaN step);
2. one ``faults`` record a round, the non-finite guard excluding every
   delivered NaN or Inf row and at most the bit-flipped ones;
3. masked-row inertness: the scenario again with the corrupted rows'
   content swapped (NaN and Inf) gives bit-identical final parameters;
4. the applied aggregate's distance to the honest participants' mean is
   finite every round (the audit monitor's ``audit`` record) and, without
   an attack, within :data:`DEV_FACTOR` honest spreads;
5. (``--child`` under the supervisor) a SIGKILL or a hang at a round, then
   the group kill and a relaunch under ``BLADES_RESUME=1``, resumes bit for
   bit;
6. every eighth scenario again through ``Simulator.run(block_size=2)``,
   bit for bit;
7. the async scenarios' ``async`` records keep their buffer arithmetic.

The sweep runs through ``sweeps.resilient.run_cells_resilient``, one seed
a cell: a failing seed is retried, then quarantined, and the others run;
with ``BLADES_RESUME=1`` the seeds in ``<out>/sweep_journal.jsonl`` are
recovered and only the rest run. Usage::

    python -m blades_tpu_torch.examples.chaos --sweep 24 [--device cpu]
    python -m blades_tpu_torch.examples.chaos --child --seed 3 --out DIR \\
        [--kill-at R | --hang-at R] [--params-out F]

The service part of the JAX suite (``service_chaos`` :1101,
``--service`` and ``--via-service``) needs the simulation service,
``ROADMAP.md`` queue A, slice 13b, and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: the registry without byzantinesgd (its default thresholds filter every
#: row of these small runs) and the async family's duplicate
AGG_POOL = (
    "mean", "median", "trimmedmean", "krum", "multikrum", "geomed",
    "autogm", "centeredclipping", "clustering", "clippedclustering",
    "fltrust", "dnc", "signguard", "asyncmean",
)
ATTACK_POOL = (None, "signflipping", "ipm", "alie")
NUM_CLIENTS = 8
ROUNDS = 3
#: attack-free rounds keep the aggregate within this many honest spreads
#: of the honest participants' mean (invariant 4)
DEV_FACTOR = 8.0
#: recorded, not bounded: asyncmean's 1/K damping pulls toward the origin
#: by design when clients drop
DEV_EXEMPT = ("asyncmean",)

_SLICE_13B = ("the simulation service, not ported to blades_tpu_torch yet "
              "(ROADMAP.md queue A, slice 13b)")


def make_scenario(seed: int) -> dict:
    """The scenario of ``seed`` (JSON-serializable: a ``--child`` rebuilds
    it from the seed), drawn exactly as ``scripts/chaos.py`` draws it."""
    import numpy as np

    rng = np.random.default_rng(1000 + seed)
    agg = AGG_POOL[seed % len(AGG_POOL)]
    agg_kws = ({"num_byzantine": 2} if agg in ("trimmedmean", "krum", "multikrum", "dnc")
               else {})

    attack = ATTACK_POOL[int(rng.integers(len(ATTACK_POOL)))]
    num_byz = int(rng.integers(1, 3)) if attack else 0

    fault: dict = {}
    participation = rng.random()
    if participation < 0.5:
        fault["dropout_rate"] = float(rng.choice([0.2, 0.3, 0.5]))
    elif participation < 0.7:
        period = int(rng.integers(2, 4))
        sched = rng.random((period, NUM_CLIENTS)) < 0.7
        sched[0, 0] = True  # at least one participant slot
        fault["participation_schedule"] = sched.tolist()
    if rng.random() < 0.4:
        fault["straggler_rate"] = float(rng.choice([0.2, 0.4]))
        fault["max_staleness"] = int(rng.integers(1, 4))
    corruption = rng.random()
    if corruption < 0.45:
        n_bad = int(rng.integers(1, 3))
        fault["corrupt_clients"] = [int(c) for c in rng.choice(NUM_CLIENTS, size=n_bad,
                                                              replace=False)]
        fault["corrupt_mode"] = str(rng.choice(["nan", "inf", "bitflip"]))
    elif corruption < 0.65:
        fault["corrupt_rate"] = 0.2
        fault["corrupt_mode"] = str(rng.choice(["nan", "inf"]))
    if not fault:
        fault["dropout_rate"] = 0.3  # every scenario has some weather

    scn = {"seed": seed, "agg": agg, "agg_kws": agg_kws, "attack": attack,
           "num_byz": num_byz, "fault": fault, "rounds": ROUNDS,
           "sim_seed": int(rng.integers(10_000))}

    # every sixth seed: buffered-async rounds, from a stream of their own
    # (the other scenarios' draws stay as they were)
    if seed % 6 == 5:
        arng = np.random.default_rng(5000 + seed)
        # the async round has real arrival staleness and refuses straggler
        # replay
        fault.pop("straggler_rate", None)
        fault.pop("max_staleness", None)
        if not fault:
            fault["dropout_rate"] = 0.3
        scn["async"] = {
            "buffer_m": int(arng.integers(2, NUM_CLIENTS - 1)),
            "arrivals": {"kind": "uniform", "max_delay": int(arng.integers(1, 4))},
            "staleness": str(arng.choice(["constant", "polynomial"])),
            "alpha": 0.5,
        }
    return scn


def inertness_variant(scn: dict) -> Optional[dict]:
    """The NaN <-> Inf twin of ``scn`` (None without whole-row corruption):
    the same rows poisoned by the same draws, all excluded, so the final
    parameters must be bit-identical."""
    mode = scn["fault"].get("corrupt_mode")
    if mode not in ("nan", "inf"):
        return None
    twin = json.loads(json.dumps(scn))
    twin["fault"]["corrupt_mode"] = "inf" if mode == "nan" else "nan"
    return twin


def build_sim(scn: dict, log_path: str, device=None):
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    sim = Simulator(
        dataset=Synthetic(num_clients=NUM_CLIENTS, train_size=400, test_size=80, noise=0.3,
                          cache=False),
        aggregator=scn["agg"], aggregator_kws=scn["agg_kws"], attack=scn["attack"],
        num_byzantine=scn["num_byz"], log_path=log_path, seed=scn["sim_seed"], device=device)
    if scn["agg"] == "fltrust":
        # trust the last client: honest (the byzantine ids come first) and
        # outside most corrupt_clients draws
        sim.set_trusted_clients([sim.get_clients()[-1]._id])
    return sim


def run_scenario(scn: dict, log_path: str, on_round_end=None, checkpoint: bool = False,
                 resume: bool = False, block_size: int = 1, engine_cache=None, device=None):
    """Run one scenario: ``(sim, final parameters flattened on the CPU)``.
    ``block_size > 1`` runs the rounds as blocks; ``engine_cache`` (a
    ``sweeps.EngineCache``) lets a rerun of the same configuration (the
    inertness twin, the block rerun) reuse its engine."""
    from blades_tpu_torch.ops.pytree import ravel

    sim = build_sim(scn, log_path, device)
    kw = dict(
        engine_cache=engine_cache, global_rounds=scn["rounds"], local_steps=1,
        train_batch_size=8, client_lr=0.2, server_lr=1.0, validate_interval=scn["rounds"],
        fault_model=dict(scn["fault"]),
        async_config=dict(scn["async"]) if scn.get("async") is not None else None,
        # the record-only audit: each round's deviation in the trace
        audit_monitor=dict(), on_round_end=on_round_end, resume=resume, block_size=block_size,
    )
    if checkpoint:
        kw.update(checkpoint_path=os.path.join(log_path, "ck"), checkpoint_interval=1)
    sim.run("mlp", **kw)
    return sim, ravel(sim.server.state.params, sim.engine.layout).detach().cpu()


def _trace(log_path: str) -> list:
    recs = []
    trace = os.path.join(log_path, "telemetry.jsonl")
    if os.path.exists(trace):
        with open(trace) as f:
            for line in f:
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    pass
    return recs


def check_invariants(scn: dict, log_path: str, params) -> list:
    """Invariants 1, 2, 4 and 7 of a finished scenario: the violations."""
    import math

    import torch

    violations = []
    if not bool(torch.isfinite(params).all()):
        violations.append("non-finite final parameters")
    recs = _trace(log_path)
    faults = [r for r in recs if r.get("t") == "faults"]
    if len(faults) != scn["rounds"]:
        violations.append(f"expected {scn['rounds']} faults records, got {len(faults)}")
    mode = scn["fault"].get("corrupt_mode")
    for r in faults:
        if r["participants"] > NUM_CLIENTS:
            violations.append(f"participants {r['participants']} > K")
        if mode in ("nan", "inf"):
            if r["excluded_nonfinite"] != r["corrupted"]:
                violations.append(f"round {r['round']}: corrupted={r['corrupted']} but "
                                  f"excluded_nonfinite={r['excluded_nonfinite']}")
        elif r["excluded_nonfinite"] > r["corrupted"]:
            violations.append(f"round {r['round']}: excluded {r['excluded_nonfinite']} "
                              f"> corrupted {r['corrupted']} (honest rows went non-finite)")
    if scn.get("async") is not None:
        asy = [r for r in recs if r.get("t") == "async"]
        if len(asy) != scn["rounds"]:
            violations.append(f"expected {scn['rounds']} async records, got {len(asy)}")
        m_thresh = min(scn["async"]["buffer_m"], NUM_CLIENTS)
        prev_fires = 0
        for r in asy:
            if r["fired"] != int(r["buffer_count"] >= m_thresh):
                violations.append(f"round {r['round']}: fired={r['fired']} but "
                                  f"buffer_count={r['buffer_count']} vs m={m_thresh}")
            if r["deposited"] > r["arrivals"]:
                violations.append(f"round {r['round']}: deposited {r['deposited']} > "
                                  f"arrivals {r['arrivals']}")
            if r["fires_total"] < prev_fires:
                violations.append(f"round {r['round']}: fires_total went backwards")
            prev_fires = r["fires_total"]

    for r in recs:
        if r.get("t") == "round" and not math.isfinite(r.get("train_loss", 0.0)):
            violations.append(f"round {r['round']}: non-finite train_loss")

    audits = [r for r in recs if r.get("t") == "audit"]
    if len(audits) != scn["rounds"]:
        violations.append(f"expected {scn['rounds']} audit records, got {len(audits)}")
    for r in audits:
        dev = r.get("dev_honest")
        spread = r.get("max_honest_dev")
        if dev is None or not math.isfinite(dev):
            violations.append(f"round {r['round']}: non-finite dev_honest")
            continue
        if not math.isfinite(spread):
            violations.append(f"round {r['round']}: non-finite max_honest_dev")
            continue
        # bounded only without an attack, with 2 honest participants and a
        # non-skip aggregate (FLTrust's degraded rounds apply zero)
        if (scn["attack"] is None and scn["agg"] not in DEV_EXEMPT
                and r.get("honest_participants", 0) >= 2 and r.get("agg_norm", 0.0) > 0.0
                and dev > max(DEV_FACTOR * spread, 1e-3)):
            violations.append(f"round {r['round']}: attack-free aggregate deviates {dev:.4g} "
                              f"from the honest mean (> {DEV_FACTOR} * spread {spread:.4g})")
    return violations


def max_dev_ratio(log_path: str):
    """The largest ``dev_honest / spread`` of a scenario's audit records
    (None without any); rounds with fewer than 2 honest participants or no
    spread are left out."""
    ratios = []
    for r in _trace(log_path):
        if r.get("t") != "audit" or "dev_honest" not in r:
            continue
        spread = r.get("max_honest_dev", 0.0)
        if r.get("honest_participants", 0) < 2 or spread <= 1e-9:
            continue
        ratios.append(r["dev_honest"] / spread)
    return round(max(ratios), 4) if ratios else None


# -- the sweep ------------------------------------------------------------------


def _sweep_cell(scn: dict, seed: int, out_dir: str, cache, device=None) -> dict:
    """One seed's work, retryable as a whole: the scenario, its invariants,
    its twin and block reruns, each in a log directory of its own."""
    import math

    import torch

    log = os.path.join(out_dir, f"s{seed:03d}")
    sim, params = run_scenario(scn, log, engine_cache=cache, device=device)
    v = check_invariants(scn, log, params)
    ev = sim.evaluate(scn["rounds"], 64)
    if not math.isfinite(ev["Loss"]):
        v.append("non-finite eval loss")
    twin = inertness_variant(scn)
    if twin is not None:
        _, params2 = run_scenario(twin, os.path.join(out_dir, f"s{seed:03d}_twin"),
                                  engine_cache=cache, device=device)
        if not torch.equal(params, params2):
            v.append("nan<->inf content swap changed final params")
    block_checked = seed % 8 == 2
    if block_checked:
        _, params_blk = run_scenario(scn, os.path.join(out_dir, f"s{seed:03d}_blk"),
                                     block_size=2, engine_cache=cache, device=device)
        if not torch.equal(params, params_blk):
            v.append("block_size=2 changed final params")
    return {
        "seed": seed, "agg": scn["agg"], "attack": scn["attack"], "async": scn.get("async"),
        "fault": {k: ("schedule" if k == "participation_schedule" else val)
                  for k, val in scn["fault"].items()},
        "loss": round(float(ev["Loss"]), 4),
        "max_dev_ratio": max_dev_ratio(log),
        "twin_checked": twin is not None,
        "block_checked": block_checked,
        "violations": v,
    }


def sweep(n: int, out_dir: str, accounting=None, journal=None, attempts: int = 2,
          base_delay_s: float = 0.5, sleep=None, device=None) -> dict:
    """Scenarios 0..n-1 (with their twins and block reruns) in this
    process, one resilient cell a seed; the summary dict. ``accounting``:
    a ``telemetry.timeline.SweepAccounting``; ``journal``: a
    ``sweeps.journal.SweepJournal``, whose seeds are recovered."""
    import time as _time

    from blades_tpu_torch.sweeps import EngineCache
    from blades_tpu_torch.sweeps.resilient import ResilienceOptions, run_cells_resilient

    labels = {seed: f"s{seed:03d}/{make_scenario(seed)['agg']}" for seed in range(n)}
    if journal is not None and journal.resumed and accounting is not None:
        recovered = journal.recovered(list(labels.values()))
        accounting.resume(len(recovered), journal=journal.path,
                          quarantined=sum(journal.entry(lab) is None for lab in recovered))
    # one engine cache for the sweep: the twin and the block rerun reuse
    # the scenario's engine; its counts land in the summary
    cache = EngineCache()
    rows, _, report = run_cells_resilient(
        [(labels[seed], seed) for seed in range(n)],
        lambda seed: _sweep_cell(make_scenario(seed), seed, out_dir, cache, device),
        sweep=accounting, journal=journal,
        options=ResilienceOptions(attempts=attempts, base_delay_s=base_delay_s,
                                  sleep=sleep or _time.sleep),
        kind="chaos")
    return summarize_rows(n, rows, report, cache.stats())


def summarize_rows(n: int, rows, report, cache_stats) -> dict:
    """The sweep's summary from the executor's output."""
    results = [r for r in rows if r is not None]
    violations = [f"seed {row['seed']}: {msg}" for row in results for msg in row["violations"]]
    quarantined = [{"cell": q["cell"], "seed": int(q["cell"][1:4]), "error": q["error"],
                    "error_type": q["error_type"]} for q in report.quarantined]
    return {
        "metric": "chaos_scenarios",
        "scenarios": n,
        "aggregators_covered": sorted({r["agg"] for r in results}),
        "inertness_pairs": sum(r["twin_checked"] for r in results),
        "block_pairs": sum(r["block_checked"] for r in results),
        "async_scenarios": sum(r["async"] is not None for r in results),
        "engine_cache": cache_stats,
        "resumed_skipped": report.resumed_skipped,
        "retried": report.retried,
        "quarantined_cells": quarantined,
        "violations": violations,
        "ok": not violations and not quarantined,
        "results": results,
    }


def service_chaos(out_dir: str, full: bool = False) -> dict:
    """The simulation service's drills: not ported (slice 13b)."""
    raise NotImplementedError(f"service_chaos needs {_SLICE_13B}")


# -- the supervised child ---------------------------------------------------------


def child_main(args) -> None:
    """One scenario as a supervised workload: it beats the heartbeat each
    round (``Simulator.run``), checkpoints every round, resumes under
    ``BLADES_RESUME=1``, and SIGKILLs itself (``--kill-at``) or hangs
    (``--hang-at``) at a round once, a sentinel file beside ``--out``
    disarming the saboteur for the relaunch."""
    import signal as _signal
    import subprocess
    import time

    import numpy as np
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    scn = make_scenario(args.seed)
    # beside the log directory, which a relaunched Simulator wipes; a fresh
    # launch clears a stale one, or the saboteur would never fire again
    sentinel = os.path.normpath(args.out) + ".fault_fired"
    if os.environ.get("BLADES_RESUME") != "1" and os.path.exists(sentinel):
        os.unlink(sentinel)

    def saboteur(rnd, state, m):
        if os.path.exists(sentinel):
            return
        if args.kill_at is not None and rnd == args.kill_at:
            open(sentinel, "w").close()
            os.kill(os.getpid(), _signal.SIGKILL)  # no autosave, no clean-up
        if args.hang_at is not None and rnd == args.hang_at:
            open(sentinel, "w").close()
            # a grandchild the group kill must reap too, then a hang
            subprocess.Popen(["sleep", "600"])
            time.sleep(600)

    _, params = run_scenario(scn, args.out, on_round_end=saboteur, checkpoint=True,
                             device=args.device)
    if args.params_out:
        np.save(args.params_out, params.numpy())
    print("CHAOS_RESULT " + json.dumps({"seed": args.seed, "agg": scn["agg"],
                                        "finite": bool(torch.isfinite(params).all())}),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sweep", type=int, default=None, metavar="N",
                   help="run scenarios 0..N-1 in this process; one JSON line out")
    p.add_argument("--out", default=os.path.join(REPO, "results", "chaos_torch"))
    p.add_argument("--child", action="store_true", help="run one scenario as a supervised "
                                                        "workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kill-at", type=int, default=None)
    p.add_argument("--hang-at", type=int, default=None)
    p.add_argument("--params-out", default=None)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--service", choices=("reduced", "full"), default=None,
                   help="not ported: the simulation service is slice 13b")
    p.add_argument("--via-service", default=None, metavar="SOCK",
                   help="not ported: the simulation service is slice 13b")
    args = p.parse_args(argv)

    if args.via_service is not None or args.service is not None:
        flag = "--via-service" if args.via_service is not None else "--service"
        raise NotImplementedError(f"{flag} needs {_SLICE_13B}")
    if args.child:
        child_main(args)
        return 0
    n = args.sweep if args.sweep is not None else 24

    from blades_tpu_torch.core.engine import resolve_device
    from blades_tpu_torch.supervision.heartbeat import RESUME_ENV
    from blades_tpu_torch.sweeps import program_fingerprint
    from blades_tpu_torch.sweeps.journal import SweepJournal
    from blades_tpu_torch.telemetry import context, ledger, timeline

    device = resolve_device(args.device)
    context.activate(fresh=True)
    journal = SweepJournal(
        os.path.join(args.out, "sweep_journal.jsonl"),
        fingerprint=program_fingerprint(kind="chaos", scenarios=n, clients=NUM_CLIENTS,
                                        rounds=ROUNDS, device=str(device)),
        resume=os.environ.get(RESUME_ENV) == "1")
    # a resumed sweep's trace goes on; a fresh one starts anew
    sweep_trace = os.path.join(args.out, "sweep_trace.jsonl")
    if not journal.resumed:
        try:
            os.unlink(sweep_trace)
        except OSError:
            pass
    accounting = timeline.SweepAccounting("chaos", total=n, path=sweep_trace,
                                          meta={"device": str(device)})
    ledger_entry = ledger.run_started("chaos", config={"kind": "chaos", "scenarios": n,
                                                       "device": str(device)},
                                      artifacts=[sweep_trace, journal.path])
    try:
        summary = sweep(n, args.out, accounting=accounting, journal=journal, device=device)
    except Exception as e:
        ledger_entry.ended("crashed", error=f"{type(e).__name__}: {e}")
        raise
    finally:
        accounting.close()
        journal.close()
    ledger_entry.ended("finished", metrics={
        "scenarios": summary["scenarios"], "violations": len(summary["violations"]),
        "quarantined": len(summary["quarantined_cells"]), "ok": summary["ok"]})
    summary["device"] = str(device)
    summary["sweep_trace"] = sweep_trace
    summary["resumed"] = journal.resumed
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
