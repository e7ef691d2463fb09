"""Live sweep progress from a sweep trace: done/total, rate, ETA, splits
(counterpart: ``scripts/sweep_status.py``).

Reads the ``sweep`` records a driver's
:class:`blades_tpu_torch.telemetry.timeline.SweepAccounting` flushes at
every cell boundary (``examples/certify.py``, ``examples/chaos.py``:
``<out>/sweep_trace.jsonl``; plus the ``attack_search`` cells emitted onto
the same trace) and prints ONE JSON line (the certify driver's contract):
cells completed / total, completion fraction, last cell key + timestamp +
age, mean cell wall, ETA, and the wall / compile / execute split totals,
per sweep family. Because the driver flushes per cell, this works on a
LIVE sweep: a stuck sweep shows a growing ``last_cell_age_s`` with
``cells`` frozen, a slow one shows cells advancing (the same trail
``examples/runs.py --run-id`` reports from the ledger).

Simulation-service traces (``blades_tpu_torch/service``:
``<out>/service_trace.jsonl``) get an additional ``service`` block: queue
depth, the in-flight request's id + age, served/rejected/quarantined
counts, oldest-pending age plus its trend across the last two health
records (a wedged server shows the age GROWING between snapshots, cells
frozen), and from the latest ``metrics_snapshot`` record
(``telemetry/reqpath.py``) the rolling serving metrics: queue-wait share,
warm-request p99, queue-depth high-water mark. A pooled server
(``serve start --workers N``) adds a ``workers`` health block: busy/idle
split, restarts, kills, the oldest in-flight cell age, and the cumulative
kill/crash/replace event trail. Sweeps that ran WITHOUT an enforceable
per-cell deadline carry a ``deadline_unenforced`` count on their family
row.

Usage::

    python -m blades_tpu_torch.examples.sweep_status results/certification_torch/sweep_trace.jsonl
    python -m blades_tpu_torch.examples.sweep_status <dir>   # <dir>/sweep_trace.jsonl
                                                            # (or service_trace.jsonl)

Stdlib only, no torch import: runs on any host while the sweep runs.
Reference counterpart: none. The reference has no sweeps and no progress
surface (``src/blades/simulator.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

# the one torn-line-tolerant trace reader (a live sweep may be mid-write)
from blades_tpu_torch.examples.trace_summary import load_records as load_sweep_records

METRIC = "sweep_status"


def summarize_sweeps(
    records: List[Dict[str, Any]], now: Optional[float] = None
) -> Dict[str, Any]:
    """Per-sweep-family progress rollup from a record list."""
    now = time.time() if now is None else now
    meta = next((r for r in records if r.get("t") == "meta"), {})
    cells = [r for r in records if r.get("t") == "sweep"]
    families: Dict[str, Dict[str, Any]] = {}

    def _family(name: str) -> Dict[str, Any]:
        return families.setdefault(
            name,
            {"cells": 0, "wall_s": 0.0, "compile_s": 0.0, "execute_s": 0.0,
             "errors": 0, "total": None, "last_cell": None, "last_ts": None,
             "eta_s": None, "batched_cells": 0, "batch_keys": set(),
             "retried": 0, "quarantined": 0, "resumed_skipped": 0,
             "deadline_unenforced": 0, "max_i": None},
        )

    # resilient-execution trail (blades_tpu_torch/sweeps/resilient.py): retry /
    # quarantine / resume records make a degraded or resumed sweep
    # distinguishable from a clean one at this surface
    for r in records:
        t = r.get("t")
        if t == "retry" and r.get("sweep") is not None:
            _family(r["sweep"])["retried"] += 1
        elif t == "quarantine":
            _family(r.get("sweep", "?"))["quarantined"] += 1
        elif t == "deadline_unenforced":
            # the resilient executor RAN WITHOUT its per-cell deadline
            # (no SIGALRM on this thread/platform and no external
            # enforcement): the sweep's walls are unbounded by the
            # ladder, and the operator must know before trusting an ETA
            _family(r.get("sweep", "?"))["deadline_unenforced"] += 1
        elif t == "resume":
            fam = _family(r.get("sweep", "?"))
            # the LAST resume record's count stands (each relaunch emits
            # its own; later attempts recovered everything earlier ones
            # did and more)
            fam["resumed_skipped"] = r.get("skipped", 0)
    for c in cells:
        fam = _family(c.get("sweep", "?"))
        if c.get("total") is not None:
            fam["total"] = c["total"]
        if c.get("i") is not None:
            fam["max_i"] = max(fam["max_i"] or 0, c["i"])
        ts = c.get("ts")
        if ts is not None and (fam["last_ts"] is None or ts >= fam["last_ts"]):
            fam["last_ts"] = ts
            fam["last_cell"] = c.get("cell")
        if c.get("eta_s") is not None:
            fam["eta_s"] = c["eta_s"]
        # resumed re-emits are zero-wall PROGRESS markers for cells whose
        # real work (and errors) the interrupted attempt already
        # recorded: they advance max_i/liveness above but must not enter
        # the work stats — counting them would deflate mean_cell_s /
        # per_cell_overhead_s, double-count quarantine errors, and
        # inflate the batched-amortization ratio on every resumed trace
        if c.get("resumed"):
            continue
        fam["cells"] += 1
        fam["wall_s"] += c.get("wall_s", 0.0)
        fam["compile_s"] += c.get("compile_s", 0.0)
        fam["execute_s"] += c.get("execute_s", 0.0)
        # batched-group accounting (telemetry/timeline.py): cells served
        # from one compiled program share a `batch` key — count programs,
        # not cells, when reporting compile amortization
        if c.get("batch") is not None:
            fam["batched_cells"] += 1
            fam["batch_keys"].add(c["batch"])
        if c.get("ok") is False:
            fam["errors"] += 1
    out: Dict[str, Any] = {}
    for name, fam in families.items():
        done = fam["cells"]
        row: Dict[str, Any] = {
            "cells": done,
            "wall_s": round(fam["wall_s"], 3),
            "mean_cell_s": round(fam["wall_s"] / done, 4) if done else None,
            # per-cell program-build overhead: the share a vmapped/shared-
            # program sweep (ROADMAP item 2) would amortize away
            "per_cell_overhead_s": round(
                (fam["wall_s"] - fam["execute_s"]) / done, 4
            ) if done else None,
            "compile_s": round(fam["compile_s"], 3),
            "execute_s": round(fam["execute_s"], 3),
        }
        # batched groups: cells-per-program is the compile-amortization
        # ratio a warm-program sweep achieves (1.0 == fully sequential);
        # programs = one per batch + one per unbatched cell
        if fam["batched_cells"]:
            batches = len(fam["batch_keys"])
            programs = batches + (done - fam["batched_cells"])
            row["batched_cells"] = fam["batched_cells"]
            row["batches"] = batches
            row["cells_per_program"] = (
                round(done / programs, 2) if programs else None
            )
        # the service family's i/total are scoped PER REQUEST (reset for
        # each one), so a cross-request max-i "progress" would be
        # nonsense (frac > 1 after two requests); request progress lives
        # in the `service` block instead
        if fam["total"] is not None and name != "service":
            row["total"] = fam["total"]
            # progress from the max i-of-N stamp, not the record count: a
            # resumed trace carries the interrupted attempt's records PLUS
            # the relaunch's resumed re-emits for the same cells, and a
            # record count would report >100% completion
            progressed = fam["max_i"] if fam["max_i"] is not None else done
            row["done"] = progressed
            row["frac"] = (
                round(progressed / fam["total"], 4) if fam["total"] else None
            )
        if fam["last_cell"] is not None:
            row["last_cell"] = fam["last_cell"]
        if fam["last_ts"] is not None:
            row["last_ts"] = fam["last_ts"]
            row["last_cell_age_s"] = round(now - fam["last_ts"], 1)
        if fam["eta_s"] is not None:
            row["eta_s"] = fam["eta_s"]
        if fam["errors"]:
            row["errors"] = fam["errors"]
        # resilient-execution counts (only when nonzero — a clean sweep's
        # row stays exactly as before)
        if fam["retried"]:
            row["retried"] = fam["retried"]
        if fam["quarantined"]:
            row["quarantined"] = fam["quarantined"]
        if fam["resumed_skipped"]:
            row["resumed_skipped"] = fam["resumed_skipped"]
        if fam["deadline_unenforced"]:
            row["deadline_unenforced"] = fam["deadline_unenforced"]
        out[name] = row
    summary: Dict[str, Any] = {"sweeps": out, "cells": len(cells)}
    if meta:
        for key in ("run_id", "sweep", "cells_total"):
            if key in meta:
                summary[key] = meta[key]
    return summary


def summarize_programs(
    records: List[Dict[str, Any]], top: int = 3
) -> Optional[Dict[str, Any]]:
    """Compile-provenance rollup from ``program`` records
    (``telemetry/programs.py``, schema v7): the cold-vs-warm program
    split plus the top-``top`` build-cost programs — next to the existing
    wall/compile/execute columns, this says WHICH programs a slow sweep
    is paying for, and whether a "warm" relaunch actually rebuilt
    anything. ``None`` when the trace predates provenance (older
    committed traces — every consumer degrades to the old report)."""
    progs = [r for r in records if r.get("t") == "program"]
    if not progs:
        return None
    by_fp: Dict[str, Dict[str, Any]] = {}
    cold = warm = 0
    for r in progs:
        fp = r.get("fingerprint", "?")
        e = by_fp.setdefault(
            fp,
            {"program": r.get("program", "?"), "fingerprint": fp,
             "builds": 0, "build_s": 0.0, "causes": {}},
        )
        if r.get("outcome") == "warm-reuse":
            warm += 1
            continue
        cold += 1
        e["builds"] += 1
        cause = r.get("cause", "?")
        e["causes"][cause] = e["causes"].get(cause, 0) + 1
        e["build_s"] = round(
            e["build_s"] + r.get("trace_s", 0.0) + r.get("lower_s", 0.0)
            + r.get("compile_s", 0.0), 6,
        )
    ranked = sorted(by_fp.values(), key=lambda e: -e["build_s"])
    return {
        "programs": len(by_fp),
        "built": cold,
        "warm_reuse": warm,
        "build_s": round(sum(e["build_s"] for e in by_fp.values()), 3),
        "top": ranked[:top],
    }


def summarize_service(
    records: List[Dict[str, Any]], now: Optional[float] = None
) -> Optional[Dict[str, Any]]:
    """Service health from ``service``/``request`` records
    (``blades_tpu_torch/service``): queue depth, in-flight, cumulative
    served/rejected/quarantined counts, oldest-pending age — so a WEDGED
    server (pending requests aging, no cell progress) is distinguishable
    from a busy one (cells advancing in the ``sweeps`` block) and from an
    idle one (zero pending, recent health record). ``None`` when the
    trace carries no service records."""
    now = time.time() if now is None else now
    svc = [r for r in records if r.get("t") == "service"]
    reqs = [r for r in records if r.get("t") == "request"]
    snaps = [r for r in records if r.get("t") == "metrics_snapshot"]
    if not svc and not reqs:
        return None
    out: Dict[str, Any] = {}
    # the LAST full snapshot record stands, as a unit (`health`/`exit`
    # records carry `served`): scanning per-field across older records
    # would resurrect stale values — e.g. an oldest_pending_age_s from a
    # busy moment reported forever on an idle server, corrupting exactly
    # the wedged-vs-idle signal this block exists for
    snap = next((r for r in reversed(svc) if "served" in r), None)
    if snap is not None:
        for field in ("queue_depth", "queue_by_class", "tenants",
                      "preemptions", "in_flight", "in_flight_id",
                      "in_flight_age_s", "served", "rejected",
                      "quarantined_requests", "oldest_pending_age_s",
                      "draining", "uptime_s"):
            if field in snap:
                out[field] = snap[field]
    # oldest-pending age TREND across the last two health records that
    # carry the field: a wedged server's age grows snapshot-over-
    # snapshot; a merely busy one's resets as requests drain. Gated on
    # the LATEST snapshot still carrying an age — an idle server whose
    # newest records omit the field must not resurrect a stale trend
    # (the same last-snapshot-stands discipline as the fields above)
    ages = [
        (r["ts"], r["oldest_pending_age_s"])
        for r in svc
        if isinstance(r.get("ts"), (int, float))
        and isinstance(r.get("oldest_pending_age_s"), (int, float))
    ]
    if len(ages) >= 2 and "oldest_pending_age_s" in out:
        out["pending_age_trend_s"] = round(ages[-1][1] - ages[-2][1], 3)
    # rolling serving metrics (`metrics_snapshot` records,
    # telemetry/reqpath.py): the latest snapshot's headline numbers —
    # queue-wait share (what a scheduler must move), warm p99 (what an
    # SLO can promise), queue-depth high-water mark
    if snaps:
        m = snaps[-1]
        split = m.get("split") or {}
        if "queue_wait_share" in split:
            out["queue_wait_share"] = split["queue_wait_share"]
        warm = (m.get("latency") or {}).get("warm") or {}
        if warm.get("count"):
            out["warm_p99_s"] = warm.get("p99_s")
            out["warm_requests"] = warm.get("count")
        hwm = (m.get("queue") or {}).get("depth_hwm")
        if hwm is not None:
            out["queue_depth_hwm"] = hwm
        # scheduler rollup: preemption count + deadline-admission
        # verdicts + per-class depth high-water marks — a contended
        # multi-tenant server is legible from its trace alone
        sched = m.get("sched") or {}
        if sched:
            out["sched"] = {
                k: sched[k]
                for k in ("preemptions", "admission",
                          "queue_depth_by_class_hwm")
                if k in sched and sched[k]
            }
    # worker-pool health (the worker processes): the last health
    # snapshot's `workers` block (size / busy / idle / restarts / kills)
    # plus the oldest in-flight cell age across workers — a hung worker
    # shows its cell age growing toward the deadline here — and the
    # cumulative kill / crash / replace trail from `worker` records,
    # which survives a server that died before its next health record
    wrecs = [r for r in records if r.get("t") == "worker"]
    wsnap = snap.get("workers") if snap is not None else None
    if isinstance(wsnap, dict) or wrecs:
        wk: Dict[str, Any] = {}
        if isinstance(wsnap, dict):
            for field in ("size", "busy", "idle", "restarts", "kills"):
                if field in wsnap:
                    wk[field] = wsnap[field]
            ages = [
                w.get("cell_age_s")
                for w in (wsnap.get("by_worker") or {}).values()
                if isinstance(w, dict)
                and isinstance(w.get("cell_age_s"), (int, float))
            ]
            if ages:
                wk["oldest_cell_age_s"] = round(max(ages), 1)
        by_event: Dict[str, int] = {}
        for r in wrecs:
            ev = r.get("event", "?")
            by_event[ev] = by_event.get(ev, 0) + 1
        if by_event:
            wk["events"] = by_event
            # the record trail stands in for missing snapshot counters
            # (a crashed server's trace still reports its kill history)
            wk.setdefault("restarts", by_event.get("replace", 0))
            wk.setdefault(
                "kills",
                by_event.get("kill", 0) + by_event.get("crash", 0),
            )
        out["workers"] = wk
    last_ts = max(
        (r["ts"] for r in svc + reqs + snaps + wrecs
         if isinstance(r.get("ts"), (int, float))),
        default=None,
    )
    if last_ts is not None:
        out["last_event_ts"] = last_ts
        out["last_event_age_s"] = round(now - last_ts, 1)
    # request lifecycle rollup: admitted-without-finished ARE the pending
    # set (survives a server that died before its next health record)
    admitted: Dict[str, float] = {}
    finished: Dict[str, str] = {}
    for r in reqs:
        rid = r.get("id")
        if not rid:
            continue
        if r.get("event") == "admitted":
            admitted[rid] = r.get("ts")
        elif r.get("event") == "finished":
            finished[rid] = r.get("outcome", "ok")
    pending = {
        rid: ts for rid, ts in admitted.items() if rid not in finished
    }
    by_outcome: Dict[str, int] = {}
    for outcome in finished.values():
        by_outcome[outcome] = by_outcome.get(outcome, 0) + 1
    out["requests"] = {
        "admitted": len(admitted),
        "finished": len(finished),
        "pending": len(pending),
        **({"by_outcome": by_outcome} if by_outcome else {}),
    }
    pending_ts = [ts for ts in pending.values() if ts is not None]
    if pending_ts and "oldest_pending_age_s" not in out:
        out["oldest_pending_age_s"] = round(now - min(pending_ts), 1)
    resumes = [r for r in svc if r.get("event") == "start" and r.get("resumed")]
    if resumes:
        out["resumed_requests"] = resumes[-1]["resumed"]
    return out


def resolve_trace(target: str) -> str:
    """A trace path, or a directory containing ``sweep_trace.jsonl`` (a
    sweep driver's) or ``service_trace.jsonl`` (a simulation service's)."""
    if os.path.isdir(target):
        sweep = os.path.join(target, "sweep_trace.jsonl")
        service = os.path.join(target, "service_trace.jsonl")
        if not os.path.exists(sweep) and os.path.exists(service):
            return service
        return sweep
    return target


def _run(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace",
                   help="sweep_trace.jsonl path (or its directory)")
    args = p.parse_args(argv)
    path = resolve_trace(args.trace)
    if not os.path.exists(path):
        print(json.dumps({
            "metric": METRIC, "ok": False,
            "error": f"no sweep trace at {path}",
        }))
        return 1
    records = load_sweep_records(path)
    summary = summarize_sweeps(records)
    payload = {"metric": METRIC, "trace": path, **summary, "ok": True}
    service = summarize_service(records)
    if service is not None:
        payload["service"] = service
    programs = summarize_programs(records)
    if programs is not None:
        payload["programs"] = programs
    print(json.dumps(payload))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """One-JSON-line contract, unconditionally (the certify driver's
    discipline): even a bug in the status query must reach the driver as
    a single parseable error line, never a traceback-only death."""
    try:
        return _run(argv)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 - the contract IS the catch-all
        print(json.dumps({
            "metric": METRIC,
            "ok": False,
            "error": f"{type(e).__name__}: {e}"[:1000],
        }))
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
