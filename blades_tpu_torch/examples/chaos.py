"""The seeded chaos suite: reproducible fault weather crossed with the
defense registry, with the robustness invariants checked end to end.

Counterpart: ``scripts/chaos.py`` — ``make_scenario`` (:97) through
``summarize_rows`` (:521), the service drills and ``service_chaos``
(:557-1139), ``child_main`` (:1140), ``_main_via_service`` (:1190) and
``main`` (:1226).
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

``--service reduced|full`` runs the simulation service's drills
(:func:`service_chaos`) against real server subprocesses
(``examples/serve.py``, probe cells only, so no server imports torch):
a poison cell quarantined while its neighbours complete, backpressure
past the queue bound, a hung cell tripping the soft deadline, a drain
that loses nothing, a flooding tenant held to its quota, a batch request
preempted by an interactive one and resumed to the same reply, a worker
of the pool that aborts mid-cell (the server stays up and the replacement
runs only the unjournaled cells), a worker hung past its deadline and
killed by its parent, and, in ``full``, a supervised server SIGKILLed
mid-request that resumes from its spool and journal.
``--via-service SOCK`` submits the sweep instead as a
``sweep`` request to a running service (the chaos driver as a batch
tenant). Usage::

    python -m blades_tpu_torch.examples.chaos --service reduced
    python -m blades_tpu_torch.examples.chaos --sweep 24 --via-service SOCK
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


# -- the service drills --------------------------------------------------------
# Each drill starts a real server subprocess (examples/serve.py; probe
# cells only, so the server never imports torch) and checks the service's
# contract end to end, the metrics surface (`op: metrics`) included: its
# counters equal the replies the clients saw.


def _server_env(env_extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # a drill's server starts fresh even where this process was relaunched
    # (the SIGKILL drill's supervisor sets the variable for its relaunch)
    env.pop("BLADES_RESUME", None)
    env.update(env_extra or {})
    return env


def _serve_argv(out_dir: str, extra_args=()) -> list:
    return [sys.executable, "-m", "blades_tpu_torch.examples.serve", "start", "--out", out_dir,
            "--base-delay", "0.05", *extra_args]


def _start_server(out_dir: str, extra_args=(), env_extra=None):
    """A server subprocess and a client that waits for its socket."""
    import subprocess

    from blades_tpu_torch.service.client import ServiceClient
    from blades_tpu_torch.service.protocol import socket_path_for

    proc = subprocess.Popen(_serve_argv(out_dir, extra_args), env=_server_env(env_extra),
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    client = ServiceClient(socket_path_for(out_dir), timeout=60, connect_retries=50,
                           connect_delay_s=0.2)
    return proc, client


def _finish_server(proc, client) -> int:
    """Drain (if still up) and reap; the server's exit code."""
    from blades_tpu_torch.service.client import ServiceClient

    if proc.poll() is None:
        try:
            # a short-fused client: the drill's own may carry a long
            # relaunch-window retry budget
            ServiceClient(client.socket_path, timeout=10, connect_retries=2,
                          connect_delay_s=0.1).drain()
        except Exception:  # noqa: BLE001 - may already be draining or gone
            pass
    try:
        proc.communicate(timeout=60)
    except Exception:  # noqa: BLE001 - reap hard rather than leak
        proc.kill()
        proc.communicate()
    return proc.returncode


def _scn_poison(out_dir: str) -> dict:
    """A poison cell is quarantined with its error while its request's other
    cells and a neighbouring request complete; the metrics' quarantine
    counts equal the replies'."""
    proc, client = _start_server(os.path.join(out_dir, "poison"))
    try:
        neighbor = client.submit({"kind": "probe", "cells": [{"label": "n0", "op": "ok"}]},
                                 wait=False)
        poison = client.submit({"kind": "probe", "cells": [
            {"label": "good0", "op": "ok", "value": 1},
            {"label": "bad", "op": "fail", "message": "poison cell"},
            {"label": "good1", "op": "ok", "value": 2},
        ]})
        neighbor_reply = client.wait_result(neighbor["id"], timeout=30)
        after = client.submit({"kind": "probe", "cells": [{"label": "a0", "op": "ok"}]})
        cells = {c["label"]: c for c in poison.get("cells", [])}
        quarantined_cells = [c for c in poison.get("cells", []) if c.get("quarantined")]
        metrics = client.metrics()
        m_reqs = metrics.get("requests") or {}
        m_cells = metrics.get("cells") or {}
        metrics_consistent = (m_reqs.get("quarantined") == 1
                              and m_cells.get("quarantined") == len(quarantined_cells)
                              and m_reqs.get("rejected") == 0)
        ok = (poison.get("status") == "done" and not poison.get("ok")
              and cells["bad"].get("quarantined")
              and "poison cell" in cells["bad"].get("error", "")
              and cells["bad"].get("error_type") == "RuntimeError"
              and "result" in cells["good0"] and "result" in cells["good1"]
              and neighbor_reply["reply"]["ok"] and after.get("ok") and metrics_consistent)
        return {"name": "poison_isolated", "ok": bool(ok),
                "quarantined": [c for c in cells if cells[c].get("quarantined")],
                "metrics_consistent": bool(metrics_consistent),
                "metrics_quarantined_requests": m_reqs.get("quarantined"),
                "metrics_quarantined_cells": m_cells.get("quarantined")}
    finally:
        _finish_server(proc, client)


def _scn_backpressure(out_dir: str) -> dict:
    """Past the queue bound the server answers ``rejected: backpressure``."""
    import time as _time

    proc, client = _start_server(os.path.join(out_dir, "backpressure"), ("--max-queue", "1"))
    try:
        busy = client.submit({"kind": "probe",
                              "cells": [{"label": "s", "op": "sleep", "sleep_s": 2.0}]},
                             wait=False)
        _time.sleep(0.2)  # the sleeper is picked up
        queued = client.submit({"kind": "probe", "cells": [{"label": "q", "op": "ok"}]},
                               wait=False)
        rejected = client.submit({"kind": "probe", "cells": [{"label": "r", "op": "ok"}]},
                                 wait=False)
        drained = client.wait_result(queued["id"], timeout=30)
        metrics = client.metrics()
        backpressure_replies = 1 if rejected.get("rejected") else 0
        metrics_consistent = (
            (metrics.get("requests") or {}).get("rejected") == backpressure_replies
            and (metrics.get("rejected_by_reason") or {}).get("backpressure")
            == backpressure_replies
            and (metrics.get("queue") or {}).get("depth_hwm", 0) >= 1)
        ok = (busy.get("status") == "accepted" and queued.get("status") == "accepted"
              and rejected.get("rejected") == "backpressure" and drained["reply"]["ok"]
              and metrics_consistent)
        return {"name": "backpressure", "ok": bool(ok), "rejected_reply": rejected,
                "metrics_consistent": bool(metrics_consistent),
                "metrics_rejected_by_reason": metrics.get("rejected_by_reason")}
    finally:
        _finish_server(proc, client)


def _scn_deadline(out_dir: str) -> dict:
    """A hung cell trips the soft deadline, is retried, then quarantined,
    and the server goes on serving."""
    proc, client = _start_server(os.path.join(out_dir, "deadline"),
                                 ("--cell-deadline", "0.3", "--attempts", "2"))
    try:
        hung = client.submit({"kind": "probe", "cells": [
            {"label": "hang", "op": "sleep", "sleep_s": 60},
            {"label": "after", "op": "ok", "value": 7},
        ]}, timeout=60)
        alive = client.submit({"kind": "probe", "cells": [{"label": "ok", "op": "ok"}]})
        cells = {c["label"]: c for c in hung.get("cells", [])}
        metrics = client.metrics()
        m_cells = metrics.get("cells") or {}
        metrics_consistent = m_cells.get("quarantined") == 1 and m_cells.get("retried", 0) >= 1
        ok = (hung.get("status") == "done" and cells["hang"].get("quarantined")
              and cells["hang"].get("error_type") == "DeadlineExceeded"
              and cells["after"].get("result", {}).get("value") == 7
              and alive.get("ok") and metrics_consistent)
        return {"name": "deadline_hang", "ok": bool(ok),
                "metrics_consistent": bool(metrics_consistent), "metrics_cells": m_cells}
    finally:
        _finish_server(proc, client)


def _scn_drain(out_dir: str) -> dict:
    """A drain exits 0 and loses nothing: every request admitted before it
    ran, and its reply is in the spool."""
    from blades_tpu_torch.service.spool import RequestSpool

    served_dir = os.path.join(out_dir, "drain")
    proc, client = _start_server(served_dir)
    try:
        ids = [client.submit({"kind": "probe",
                              "cells": [{"label": f"c{i}", "op": "ok", "value": i}]},
                             wait=False)["id"] for i in range(3)]
        client.drain()
    except BaseException:
        _finish_server(proc, client)
        raise
    rc = _finish_server(proc, client)
    spool = RequestSpool(os.path.join(served_dir, "spool.jsonl"), resume=True)
    replies = {rid: spool.reply(rid) for rid in ids}
    spool.close()
    ok = rc == 0 and all(r is not None and r.get("ok") for r in replies.values())
    return {"name": "drain_no_loss", "ok": bool(ok), "rc": rc, "requests": len(ids)}


def _scn_sigkill_resume(out_dir: str) -> dict:
    """A supervised server SIGKILLed mid-request (after its 2nd journaled
    cell) is relaunched, runs only the unjournaled cells, and the reply
    equals an uninterrupted run's."""
    import subprocess

    from blades_tpu_torch.service.client import ServiceClient
    from blades_tpu_torch.service.protocol import mint_request_id, socket_path_for
    from blades_tpu_torch.sweeps.journal import KILL_AT_ENV

    request = {"kind": "probe",
               "cells": [{"label": f"c{i}", "op": "ok", "value": i} for i in range(4)]}
    proc, client = _start_server(os.path.join(out_dir, "kill_ref"))
    try:
        ref = client.submit(request, request_id="kill-ref")
    finally:
        _finish_server(proc, client)

    sup_dir = os.path.join(out_dir, "kill_sup")
    sup = subprocess.Popen(
        [sys.executable, "-m", "blades_tpu_torch.supervision", "--attempts", "2",
         "--heartbeat-timeout", "120", "--base-delay", "0.1",
         "--heartbeat-file", os.path.join(out_dir, "kill_hb"), "--", *_serve_argv(sup_dir)],
        env=_server_env({KILL_AT_ENV: "2"}), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    client = ServiceClient(socket_path_for(sup_dir), timeout=60, connect_retries=100,
                           connect_delay_s=0.2)
    rid = mint_request_id()
    try:
        try:
            client.submit(request, request_id=rid)
        except Exception:  # noqa: BLE001 - the connection dies with the SIGKILL
            pass
        recovered = client.wait_result(rid, timeout=120)
        client.drain()
    finally:
        try:
            sup.communicate(timeout=120)
        except Exception:  # noqa: BLE001 - reap hard rather than leak
            sup.kill()
            sup.communicate()
    reply = recovered["reply"]
    summary = reply.get("summary", {})
    ok = (sup.returncode == 0 and reply["cells"] == ref["cells"]
          and summary.get("resumed_skipped", 0) >= 1
          and summary.get("executed", 9) <= len(request["cells"]) - 1)
    return {"name": "sigkill_resume", "ok": bool(ok), "supervisor_rc": sup.returncode,
            "resumed_skipped": summary.get("resumed_skipped"),
            "executed": summary.get("executed"),
            "content_identical": reply["cells"] == ref["cells"]}


def _scn_tenant_flood(out_dir: str) -> dict:
    """A flooding tenant is held to its quota: every backpressure reply
    names it, the victim's interactive request completes without a
    rejection, and the per-tenant counters equal the replies."""
    import time as _time

    proc, client = _start_server(os.path.join(out_dir, "flood"),
                                 ("--max-queue", "8", "--tenant-quota", "2"))
    try:
        busy = client.submit({"kind": "probe",
                              "cells": [{"label": "s", "op": "sleep", "sleep_s": 1.5}]},
                             wait=False, client="flood", priority="batch")
        _time.sleep(0.2)  # the sleeper is picked up
        flood_replies = [client.submit({"kind": "probe",
                                        "cells": [{"label": f"f{i}", "op": "ok", "value": i}]},
                                       wait=False, client="flood", priority="batch")
                         for i in range(5)]
        rejects = [r for r in flood_replies if r.get("rejected")]
        t0 = _time.monotonic()
        victim = client.submit({"kind": "probe",
                                "cells": [{"label": "v", "op": "ok", "value": 42}]},
                               client="victim", priority="interactive", timeout=60)
        victim_wall = _time.monotonic() - t0
        rejects_attributed = all(r.get("rejected") == "backpressure"
                                 and r.get("tenant") == "flood" and r.get("scope") == "tenant"
                                 for r in rejects)
        by_client = client.metrics().get("by_client") or {}
        flood_m = by_client.get("flood") or {}
        victim_m = by_client.get("victim") or {}
        metrics_consistent = (flood_m.get("rejected") == len(rejects)
                              and victim_m.get("rejected", 0) == 0)
        ok = (busy.get("status") == "accepted" and len(rejects) >= 1 and rejects_attributed
              and victim.get("ok") and victim_wall < 20.0 and metrics_consistent)
        return {"name": "tenant_flood", "ok": bool(ok),
                "flood_submitted": len(flood_replies) + 1, "flood_rejected": len(rejects),
                "rejects_attributed": bool(rejects_attributed),
                "victim_wall_s": round(victim_wall, 3),
                "victim_rejected": victim_m.get("rejected", 0),
                "metrics_consistent": bool(metrics_consistent)}
    finally:
        _finish_server(proc, client)


def _scn_preempt_resume(out_dir: str) -> dict:
    """A long batch request yields to interactive work at a cell boundary,
    is requeued, resumes from its journal, and its reply equals an
    unpreempted run's."""
    import time as _time

    request = {"kind": "probe", "cells": [
        {"label": f"c{i}", "op": "sleep", "sleep_s": 0.3, "value": i} for i in range(6)]}
    proc, client = _start_server(os.path.join(out_dir, "preempt_ref"))
    try:
        ref = client.submit(request, request_id="preempt-ref", client="batcher",
                            priority="batch", timeout=60)
    finally:
        _finish_server(proc, client)

    proc, client = _start_server(os.path.join(out_dir, "preempt"))
    try:
        batch = client.submit(request, request_id="preempt-main", wait=False,
                              client="batcher", priority="batch")
        _time.sleep(0.5)  # mid-request when the interactive one lands
        inter = client.submit({"kind": "probe", "cells": [{"label": "i", "op": "ok", "value": 1}]},
                              client="human", priority="interactive", timeout=60)
        reply = client.wait_result(batch["id"], timeout=60)["reply"]
        summary = reply.get("summary", {})
        preemptions = (client.metrics().get("sched") or {}).get("preemptions", 0)
        content_identical = reply.get("cells") == ref.get("cells")
        ok = (inter.get("ok") and reply.get("ok") and content_identical
              and summary.get("resumed_skipped", 0) >= 1
              and summary.get("executed", -1)
              == len(request["cells"]) - summary.get("resumed_skipped", 0)
              and preemptions >= 1)
        return {"name": "preempt_resume", "ok": bool(ok),
                "content_identical": bool(content_identical),
                "resumed_skipped": summary.get("resumed_skipped"),
                "executed": summary.get("executed"), "preemptions": preemptions}
    finally:
        _finish_server(proc, client)


def _scn_worker_crash(out_dir: str) -> dict:
    """``os.abort()`` mid-cell in a worker (``--workers 1``): the server
    stays up, a later request is served, the replacement worker runs only
    the cells the dead one had not journaled, and the reply equals an
    undisturbed run's."""
    # the once sentinel arms the saboteur once: the retried attempt behaves
    sentinel = os.path.join(out_dir, "worker_crash.once")
    request = {"kind": "probe", "cells": [
        {"label": "c0", "op": "ok", "value": 0},
        {"label": "boom", "op": "abort", "once": sentinel, "value": 1},
        {"label": "c2", "op": "ok", "value": 2},
    ]}
    # the reference: with the sentinel there, the abort cell behaves
    open(sentinel, "w").close()
    proc, client = _start_server(os.path.join(out_dir, "wcrash_ref"), ("--workers", "1"))
    try:
        ref = client.submit(request, request_id="wcrash-ref", timeout=120)
    finally:
        _finish_server(proc, client)
    os.unlink(sentinel)

    proc, client = _start_server(os.path.join(out_dir, "wcrash"), ("--workers", "1"))
    try:
        hurt = client.submit(request, request_id="wcrash", timeout=120)
        after = client.submit({"kind": "probe", "cells": [{"label": "a", "op": "ok"}]},
                              timeout=60)
        workers = client.status().get("workers") or {}
        summary = hurt.get("summary") or {}
        content_identical = hurt.get("cells") == ref.get("cells")
        ok = (ref.get("status") == "done" and ref.get("ok")
              and hurt.get("status") == "done" and hurt.get("ok") and content_identical
              # the replacement ran only the unjournaled rest
              and summary.get("resumed_skipped", 0) >= 1
              and summary.get("executed", 9) <= len(request["cells"]) - 1
              and after.get("ok") and workers.get("restarts", 0) >= 1)
        return {"name": "worker_crash", "ok": bool(ok),
                "content_identical": bool(content_identical),
                "resumed_skipped": summary.get("resumed_skipped"),
                "executed": summary.get("executed"), "restarts": workers.get("restarts")}
    finally:
        _finish_server(proc, client)


def _scn_worker_hang(out_dir: str) -> dict:
    """A worker hangs past its cell's deadline in a 600 s sleep (a worker
    arms no alarm): the parent kills the worker's process group, the retry on the replacement completes the request, and the
    server serves throughout."""
    import time as _time

    sentinel = os.path.join(out_dir, "worker_hang.once")
    proc, client = _start_server(os.path.join(out_dir, "whang"),
                                 ("--workers", "1", "--cell-deadline", "0.5", "--attempts", "2"))
    try:
        t0 = _time.monotonic()
        hung = client.submit({"kind": "probe", "cells": [
            {"label": "hang", "op": "sleep", "sleep_s": 600, "once": sentinel, "value": 7},
            {"label": "after", "op": "ok", "value": 8},
        ]}, request_id="whang", timeout=120)
        wall = _time.monotonic() - t0
        alive = client.submit({"kind": "probe", "cells": [{"label": "ok", "op": "ok"}]},
                              timeout=60)
        workers = client.status().get("workers") or {}
        cells = {c["label"]: c for c in hung.get("cells", [])}
        ok = (hung.get("status") == "done" and hung.get("ok")
              # the retried attempt completed the cell: a 600 s sleep cost
              # one deadline
              and cells["hang"].get("result", {}).get("value") == 7
              and not cells["hang"].get("quarantined")
              and cells["after"].get("result", {}).get("value") == 8
              and wall < 60.0 and alive.get("ok")
              and workers.get("kills", 0) >= 1 and workers.get("restarts", 0) >= 1)
        return {"name": "worker_hang", "ok": bool(ok), "wall_s": round(wall, 3),
                "kills": workers.get("kills"), "restarts": workers.get("restarts")}
    finally:
        _finish_server(proc, client)


def service_chaos(out_dir: str, full: bool = False) -> dict:
    """The service drills; a summary dict. ``full`` adds the supervised
    SIGKILL resume."""
    import shutil

    scenarios = [_scn_poison, _scn_backpressure, _scn_deadline, _scn_drain,
                 _scn_tenant_flood, _scn_preempt_resume, _scn_worker_crash, _scn_worker_hang]
    if full:
        scenarios.append(_scn_sigkill_resume)
    # the drills use fixed request ids: a stale journal or spool of an
    # earlier run would resume instead of exercising the saboteur
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for scn in scenarios:
        try:
            rows.append(scn(out_dir))
        except Exception as e:  # noqa: BLE001 - a failed drill is a row
            rows.append({"name": scn.__name__.replace("_scn_", ""), "ok": False,
                         "error": f"{type(e).__name__}: {e}"[:300]})
    return {"metric": "chaos_service", "scenarios": rows, "ok": all(r["ok"] for r in rows)}


def _main_via_service(args) -> int:
    """The chaos sweep as a tenant of a running service: one ``sweep``
    request (priority ``batch``), the summary in its reply; one JSON line
    either way."""
    from blades_tpu_torch.service.client import ServiceClient, ServiceError

    n = args.sweep if args.sweep is not None else 24
    try:
        client = ServiceClient(args.via_service, timeout=args.service_timeout)
        reply = client.submit({"kind": "sweep", "sweep": "chaos", "spec": {"scenarios": n}},
                              client="chaos", priority="batch", timeout=args.service_timeout)
        if not reply.get("ok") or "sweep" not in reply:
            print(json.dumps({"metric": "chaos_scenarios", "ok": False,
                              "via_service": args.via_service, "reply": reply}))
            return 1
        summary = reply["sweep"]["summary"]
        summary["via_service"] = args.via_service
        summary["request_id"] = reply.get("id")
        print(json.dumps(summary))
        return 0 if summary.get("ok") else 1
    except ServiceError as e:
        print(json.dumps({"metric": "chaos_scenarios", "ok": False,
                          "via_service": args.via_service,
                          "error": f"{type(e).__name__}: {e}"[:500]}))
        return 1


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

    from blades_tpu_torch.utils.platform import apply_numerics

    apply_numerics()

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
                   help="run the simulation service's drills (full adds the supervised "
                        "SIGKILL resume); alone (no --sweep) prints just their JSON line")
    p.add_argument("--via-service", default=None, metavar="SOCK",
                   help="submit the sweep as a sweep request to a running simulation service")
    p.add_argument("--service-timeout", type=float, default=3600.0,
                   help="--via-service: how long to wait for the reply (seconds)")
    args = p.parse_args(argv)

    if args.via_service is not None:
        return _main_via_service(args)
    if args.child:
        child_main(args)
        return 0
    if args.service is not None and args.sweep is None:
        summary = service_chaos(os.path.join(args.out, "service"), full=args.service == "full")
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1
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
    if args.service is not None:
        summary["service"] = service_chaos(os.path.join(args.out, "service"),
                                           full=args.service == "full")
        summary["ok"] = summary["ok"] and summary["service"]["ok"]
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
