"""Per-stage cost table from a telemetry JSONL trace (counterpart:
``scripts/trace_summary.py``).

Reads a trace written by ``blades_tpu_torch.telemetry`` (``telemetry.jsonl``
in a run's log dir) and prints where the rounds spent their time: span
tree totals (sample / dispatch / sync / eval), compile and cache
accounting, and defense-forensics summaries. Service traces
(``service_trace.jsonl``) additionally get a serving-path section
(``telemetry/reqpath.py``): per-request queue-wait/build/execute split
totals, warm/cold request counts, warm p99 and queue-wait share from the
latest ``metrics_snapshot`` record, with ``--compare`` rows for both
headline numbers.

A copy of the JAX package's reader, stdlib only, so that the port reads
its own records without importing that package; it also reads a JAX
trace. The sections for records the port never writes (the ``xla.*``
counters, ``program[...]`` cost records, the ``eval_warmup`` and
``round/program_profile`` spans) stay for that reason. One change:
the heartbeat hint's threshold comes from the port's
``supervision/heartbeat.py`` (``format_table``).

Reference counterpart: none. The reference records only whole-round wall
time (``src/blades/simulator.py:453-455``), so it has nothing to summarize.

Usage::

    python -m blades_tpu_torch.examples.trace_summary LOG/telemetry.jsonl [--json]
    python -m blades_tpu_torch.examples.trace_summary --compare A.jsonl B.jsonl [--force]

``--json`` emits the summary dict instead of the table (machine-readable,
used by tests). ``--compare`` diffs two runs' per-stage cost tables and
counters side by side, and refuses two traces whose config fingerprints
differ unless ``--force``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List


def load_records(path: str) -> List[dict]:
    """Parse a telemetry JSONL file (skips blank/corrupt lines — a live run
    may be mid-write)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def summarize(records: List[dict]) -> dict:
    """Aggregate a record list into span/counter/round/defense summaries."""
    spans: Dict[str, dict] = {}
    counters: Dict[str, float] = {}
    rounds = []
    compiles = []
    defenses = []
    audits = []
    metrics = []
    timelines = []
    sweep_cells = []
    service_events = []
    request_events = []
    metrics_snapshots = []
    programs = []
    prov_records = []
    cache_stats = []
    profile_events = []
    margins = []
    alerts = []
    asyncs = []
    supervisor: Dict[str, int] = {}
    kill_reasons = []
    meta = {}
    # run identity (telemetry/context.py): every record carries the
    # run_id/attempt envelope; a supervised trace stitches several
    # attempts of ONE run_id, so collect the attempt set per id
    run_attempts: Dict[str, set] = {}
    for r in records:
        t = r.get("t")
        rid = r.get("run_id")
        if isinstance(rid, str):
            run_attempts.setdefault(rid, set()).add(r.get("attempt"))
        if t == "span":
            s = spans.setdefault(
                r["path"], {"count": 0, "total_s": 0.0, "max_s": 0.0}
            )
            s["count"] += 1
            s["total_s"] += r["dur_s"]
            s["max_s"] = max(s["max_s"], r["dur_s"])
        elif t == "round":
            rounds.append(r)
            for k, v in (r.get("counters") or {}).items():
                counters[k] = counters.get(k, 0) + v
        elif t == "compile":
            compiles.append(r["dur_s"])
        elif t == "defense":
            defenses.append(r)
        elif t == "audit":
            audits.append(r)
        elif t == "metrics":
            metrics.append(r)
        elif t == "timeline":
            timelines.append(r)
        elif t == "sweep":
            sweep_cells.append(r)
        elif t == "service":
            service_events.append(r)
        elif t == "request":
            request_events.append(r)
        elif t == "metrics_snapshot":
            metrics_snapshots.append(r)
        elif t == "async":
            asyncs.append(r)
        elif t == "memory":
            programs.append(r)
        elif t == "program":
            prov_records.append(r)
        elif t == "cache_stats":
            cache_stats.append(r)
        elif t == "profile":
            profile_events.append(r)
        elif t == "heartbeat_margin":
            margins.append(r)
        elif t == "alert":
            alerts.append(r)
        elif t == "supervisor":
            ev = r.get("event", "?")
            supervisor[ev] = supervisor.get(ev, 0) + 1
            if ev == "kill":
                kill_reasons.append(r.get("reason"))
        elif t == "meta":
            # a supervised trace interleaves supervisor + run meta records;
            # keep the RUN's config (the supervisor's carries only cmd)
            if r.get("run") != "supervisor":
                meta.update(r)
    for s in spans.values():
        s["mean_s"] = s["total_s"] / s["count"]

    round_walls = [r["wall_s"] for r in rounds if "wall_s" in r]
    defense_summary: Dict[str, float] = {}
    for key in (
        "byz_selected_frac",
        "byz_trim_frac",
        "byz_clipped_frac",
        "honest_clipped_frac",
        "byz_trust_frac",
    ):
        vals = [d[key] for d in defenses if key in d]
        if vals:
            defense_summary[f"mean_{key}"] = sum(vals) / len(vals)

    # runtime-audit rollup (blades_tpu/audit, docs/observability.md):
    # breach/fallback counts + worst recorded honest-deviation ratio
    audit_summary: Dict[str, float] = {}
    if audits:
        audit_summary["rounds_audited"] = len(audits)
        audit_summary["breaches"] = sum(r.get("breach", 0) for r in audits)
        audit_summary["fallback_rounds"] = sum(
            r.get("fallback_used", 0) for r in audits
        )
        # same degenerate-denominator skip as scripts/chaos.py's
        # max_dev_ratio: < 2 honest participants or ~zero honest spread
        # says nothing about the defense
        ratios = [
            r["dev_honest"] / r["max_honest_dev"]
            for r in audits
            if "dev_honest" in r
            and r.get("honest_participants", 0) >= 2
            and r.get("max_honest_dev", 0.0) > 1e-9
        ]
        if ratios:
            audit_summary["max_dev_ratio"] = max(ratios)
            audit_summary["mean_dev_ratio"] = sum(ratios) / len(ratios)

    # round-block runs (Simulator.run(block_size>1)) emit `block`-rooted
    # spans covering several rounds each; normalize them to per-round
    # averages so the per-stage cost table stays comparable with per-round
    # (`round`-rooted) traces — the `round` records are per-round in both
    # worlds, so their count is the normalizer
    block_summary = {}
    block_root = spans.get("block")
    if block_root and rounds:
        block_summary = {
            "blocks": block_root["count"],
            "rounds": len(rounds),
            "rounds_per_block": len(rounds) / block_root["count"],
            "per_round_mean_s": {
                path: s["total_s"] / len(rounds)
                for path, s in spans.items()
                if path == "block" or path.startswith("block/")
            },
        }

    # per-round peak update-matrix bytes (engine.* gauges ride every round
    # record): surfaces streaming-vs-dense memory regressions in traces —
    # a round whose peak grew back to [K, D] is a bug, not noise
    memory_summary: Dict[str, float] = {}
    peak_vals = [
        r["gauges"]["engine.peak_update_bytes"]
        for r in rounds
        if "engine.peak_update_bytes" in (r.get("gauges") or {})
    ]
    if peak_vals:
        memory_summary["peak_update_bytes"] = max(peak_vals)
        last_gauges = next(
            (
                r["gauges"]
                for r in reversed(rounds)
                if "engine.peak_update_bytes" in (r.get("gauges") or {})
            ),
            {},
        )
        for key in ("engine.streaming", "engine.client_chunks",
                    "engine.chunk_size"):
            if key in last_gauges:
                memory_summary[key.split(".", 1)[1]] = last_gauges[key]
    # MEASURED allocator watermarks (mem.* gauges, profiling.py) next to
    # the analytical estimate — absent on backends without memory_stats
    live_vals = [
        r["gauges"]["mem.peak_bytes_in_use"]
        for r in rounds
        if "mem.peak_bytes_in_use" in (r.get("gauges") or {})
    ]
    if live_vals:
        memory_summary["measured_peak_bytes_in_use"] = max(live_vals)

    # in-graph round metrics (`metrics` records, telemetry/metric_pack.py):
    # honest/byz geometry means + worst-round extremes
    metrics_summary: Dict[str, float] = {}
    if metrics:
        metrics_summary["rounds"] = len(metrics)
        for key in ("cos_honest", "cos_byz"):
            vals = [m[key] for m in metrics if key in m]
            if vals:
                metrics_summary[f"mean_{key}"] = sum(vals) / len(vals)
        medians = [m["norm_median"] for m in metrics if "norm_median" in m]
        if medians:
            metrics_summary["max_norm_median"] = max(medians)
        excl = [m.get("masked_out", 0) for m in metrics]
        metrics_summary["max_masked_out"] = max(excl) if excl else 0

    # buffered-async rollup (`async` records, blades_tpu/asyncfl): fire
    # cadence + staleness over the run — the quick health read for a
    # FedBuff-style run (a fire rate near 0 means buffer_m is set above
    # what the arrival process can deliver)
    async_summary: Dict[str, float] = {}
    if asyncs:
        fires = sum(r.get("fired", 0) for r in asyncs)
        async_summary["ticks"] = len(asyncs)
        async_summary["fires"] = fires
        async_summary["fire_rate"] = fires / len(asyncs)
        taus = [
            r["mean_staleness"] for r in asyncs
            if r.get("fired") and "mean_staleness" in r
        ]
        if taus:
            async_summary["mean_staleness"] = sum(taus) / len(taus)
        async_summary["max_staleness"] = max(
            (r.get("max_staleness", 0) for r in asyncs), default=0
        )
        async_summary["stale_excluded"] = sum(
            r.get("stale_excluded", 0) for r in asyncs
        )

    # dispatch accounting (`timeline` records, telemetry/timeline.py):
    # per-launch host-enqueue vs device-ready split, aggregated per launch
    # kind — THE number that says whether a slow run is dispatch-bound
    # (the claim ROADMAP items 2-4 rest on) or device-bound
    dispatch_summary: Dict[str, Any] = {}
    if timelines:
        by_kind: Dict[str, Dict[str, float]] = {}
        for r in timelines:
            k = by_kind.setdefault(
                r.get("kind", "?"),
                {"launches": 0, "rounds": 0, "enqueue_s": 0.0,
                 "ready_s": 0.0, "compile_s": 0.0, "compiles": 0},
            )
            k["launches"] += r.get("launches", 0)
            k["rounds"] += r.get("rounds", 0)
            k["enqueue_s"] += r.get("enqueue_s", 0.0)
            k["ready_s"] += r.get("ready_s", 0.0)
            k["compile_s"] += r.get("compile_s", 0.0)
            k["compiles"] += r.get("compiles", 0)
        enq = sum(k["enqueue_s"] for k in by_kind.values())
        rdy = sum(k["ready_s"] for k in by_kind.values())
        for k in by_kind.values():
            tot = k["enqueue_s"] + k["ready_s"]
            k["dispatch_share"] = round(k["enqueue_s"] / tot, 4) if tot else 0.0
        dispatch_summary = {
            "launches": sum(k["launches"] for k in by_kind.values()),
            "enqueue_s": enq,
            "ready_s": rdy,
            "dispatch_share": round(enq / (enq + rdy), 4)
            if (enq + rdy)
            else 0.0,
            "by_kind": by_kind,
        }

    # sweep accounting (`sweep` records): per-cell progress + the
    # wall/compile/execute split of each sweep family — scripts/
    # sweep_status.py owns the live view; this is the post-mortem rollup
    sweep_summary: Dict[str, Any] = {}
    if sweep_cells:
        fams: Dict[str, Dict[str, Any]] = {}
        for c in sweep_cells:
            f = fams.setdefault(
                c.get("sweep", "?"),
                {"cells": 0, "wall_s": 0.0, "compile_s": 0.0,
                 "execute_s": 0.0, "total": None},
            )
            f["cells"] += 1
            f["wall_s"] += c.get("wall_s", 0.0)
            f["compile_s"] += c.get("compile_s", 0.0)
            f["execute_s"] += c.get("execute_s", 0.0)
            if c.get("total") is not None:
                f["total"] = c["total"]
        for f in fams.values():
            n = f["cells"] or 1
            f["mean_cell_s"] = round(f["wall_s"] / n, 4)
            # per-cell program-build overhead: what an experiment-axis
            # vmap / shared compiled program would amortize away
            f["per_cell_overhead_s"] = round(
                (f["wall_s"] - f["execute_s"]) / n, 4
            )
        sweep_summary = fams

    # serving-path accounting (`service`/`request`/`metrics_snapshot`
    # records, blades_tpu/service + telemetry/reqpath.py): per-request
    # queue-wait/build/execute split totals, warm/cold request counts,
    # and the latest rolling-metrics snapshot's headline numbers — the
    # post-mortem rollup of a service trace (sweep_status owns the live
    # view)
    service_summary: Dict[str, Any] = {}
    if service_events or request_events or metrics_snapshots:
        finished = [
            r for r in request_events if r.get("event") == "finished"
        ]
        service_summary["requests_finished"] = len(finished)
        for key in ("queue_wait_s", "build_s", "execute_s", "total_s"):
            vals = [r[key] for r in finished if key in r]
            if vals:
                service_summary[key] = round(sum(vals), 6)
        tot = service_summary.get("total_s")
        if tot:
            service_summary["queue_wait_share"] = round(
                service_summary.get("queue_wait_s", 0.0) / tot, 4
            )
        warm_flags = [r["warm"] for r in finished if "warm" in r]
        if warm_flags:
            service_summary["warm_requests"] = sum(warm_flags)
            service_summary["cold_requests"] = (
                len(warm_flags) - sum(warm_flags)
            )
        exit_snap = next(
            (r for r in reversed(service_events) if "served" in r), None
        )
        if exit_snap is not None:
            for key in ("served", "rejected", "quarantined_requests"):
                if key in exit_snap:
                    service_summary[key] = exit_snap[key]
        if metrics_snapshots:
            m = metrics_snapshots[-1]
            warm = (m.get("latency") or {}).get("warm") or {}
            if warm.get("count"):
                service_summary["warm_p99_s"] = warm.get("p99_s")
            total_lat = (m.get("latency") or {}).get("total") or {}
            if total_lat.get("count"):
                service_summary["total_p99_s"] = total_lat.get("p99_s")
            hwm = (m.get("queue") or {}).get("depth_hwm")
            if hwm is not None:
                service_summary["queue_depth_hwm"] = hwm

    # measured program profiles (`memory` records): cost-model flops /
    # bytes + compiled buffer budget per program, next to the analytical
    # peak_update_bytes gauge above
    program_summary: Dict[str, dict] = {}
    for p in programs:
        name = p.get("program", "?")
        program_summary[name] = {
            k: v for k, v in p.items() if k not in ("t", "program")
        }

    # compile provenance (`program` records, telemetry/programs.py,
    # schema v7): which program built, why, and what it cost — keyed by
    # fingerprint so a `--compare` can say "run B compiled these programs
    # run A didn't". Older traces simply have no records here; every
    # consumer (format_table, compare_format) treats an absent section as
    # "predates provenance", never as an error.
    provenance_summary: Dict[str, Any] = {}
    if prov_records:
        by_fp: Dict[str, Dict[str, Any]] = {}
        for r in prov_records:
            fp = r.get("fingerprint", "?")
            e = by_fp.setdefault(
                fp,
                {"program": r.get("program", "?"), "builds": 0, "warm": 0,
                 "trace_s": 0.0, "lower_s": 0.0, "compile_s": 0.0,
                 "compiles": 0, "causes": {}},
            )
            if r.get("outcome") == "warm-reuse":
                e["warm"] += 1
            else:
                e["builds"] += 1
                cause = r.get("cause", "?")
                e["causes"][cause] = e["causes"].get(cause, 0) + 1
                for key in ("trace_s", "lower_s", "compile_s"):
                    e[key] = round(e[key] + r.get(key, 0.0), 6)
                e["compiles"] += r.get("compiles", 0)
        for e in by_fp.values():
            e["build_s"] = round(
                e["trace_s"] + e["lower_s"] + e["compile_s"], 6
            )
        builds = sum(e["builds"] for e in by_fp.values())
        provenance_summary = {
            "programs": len(by_fp),
            "builds": builds,
            "cold": sum(
                1 for r in prov_records if r.get("outcome") == "cold"
            ),
            "warm_only": sum(
                1 for e in by_fp.values() if e["builds"] == 0
            ),
            "build_s": round(
                sum(e["build_s"] for e in by_fp.values()), 6
            ),
            "by_fingerprint": by_fp,
        }
    if cache_stats:
        # last snapshot stands (cumulative counters, like the service
        # health records)
        last = cache_stats[-1]
        provenance_summary["cache"] = {
            k: last[k]
            for k in ("entries", "hits", "misses", "evictions")
            if k in last
        }

    # heartbeat margin (supervision.heartbeat + BLADES_HEARTBEAT_TIMEOUT):
    # how close beats came to the supervisor's kill threshold
    heartbeat_summary: Dict[str, float] = {}
    intervals = [
        r["gauges"]["heartbeat.interval_s"]
        for r in rounds
        if "heartbeat.interval_s" in (r.get("gauges") or {})
    ]
    if intervals:
        heartbeat_summary["max_interval_s"] = max(intervals)
    if margins:
        heartbeat_summary["warnings"] = len(margins)
        heartbeat_summary["min_margin_s"] = min(
            m["margin_s"] for m in margins
        )
        heartbeat_summary["timeout_s"] = margins[-1].get("timeout_s")

    # run-identity rollup: who this trace belongs to. A normal trace has
    # one run_id and one attempt; a supervised stitched trace has one id
    # with attempts 1..n; multiple ids mean concatenated unrelated runs.
    run_summary: Dict[str, object] = {}
    if run_attempts:
        ids = sorted(run_attempts)
        primary = meta.get("run_id") or ids[0]
        run_summary["run_id"] = primary
        run_summary["attempts"] = sorted(
            a for a in run_attempts.get(primary, set()) if isinstance(a, int)
        )
        if len(ids) > 1:
            run_summary["other_run_ids"] = [i for i in ids if i != primary]
    if "config_fingerprint" in meta:
        run_summary["config_fingerprint"] = meta["config_fingerprint"]

    # anomaly alerts (telemetry/alerts.py): each rule fires at most once
    # per run, so the rollup is small by construction
    alert_summary: Dict[str, object] = {}
    if alerts:
        alert_summary["count"] = len(alerts)
        by_sev: Dict[str, int] = {}
        for a in alerts:
            sev = a.get("severity", "?")
            by_sev[sev] = by_sev.get(sev, 0) + 1
        alert_summary["by_severity"] = by_sev
        alert_summary["rules"] = sorted(
            {a.get("rule", "?") for a in alerts}
        )
        first_critical = next(
            (a for a in alerts if a.get("severity") == "critical"), None
        )
        if first_critical:
            alert_summary["first_critical"] = {
                k: first_critical.get(k)
                for k in ("rule", "round", "message")
                if k in first_critical
            }

    return {
        "meta": meta,
        "run": run_summary,
        "alerts": alert_summary,
        "spans": spans,
        "counters": counters,
        "memory": memory_summary,
        "dispatch": dispatch_summary,
        "sweep": sweep_summary,
        "service": service_summary,
        "metrics": metrics_summary,
        "programs": program_summary,
        "provenance": provenance_summary,
        "heartbeat": heartbeat_summary,
        "profile_events": len(profile_events),
        "block": block_summary,
        "rounds": {
            "count": len(rounds),
            "total_wall_s": sum(round_walls),
            "mean_wall_s": (
                sum(round_walls) / len(round_walls) if round_walls else 0.0
            ),
        },
        "compiles": {
            "count": len(compiles),
            "total_s": sum(compiles),
            "max_s": max(compiles) if compiles else 0.0,
        },
        "defense": defense_summary,
        "audit": audit_summary,
        "async": async_summary,
        "supervisor": {"events": supervisor, "kill_reasons": kill_reasons},
    }


def format_table(summary: dict) -> str:
    """The human-readable per-stage cost table."""
    lines = []
    meta = summary["meta"]
    run = summary.get("run") or {}
    if run.get("run_id"):
        parts = [f"run_id: {run['run_id']}"]
        attempts = run.get("attempts") or []
        if attempts and attempts != [1]:
            parts.append(f"attempts {attempts[0]}..{attempts[-1]}")
        if run.get("config_fingerprint"):
            parts.append(f"config {run['config_fingerprint']}")
        lines.append("  ".join(parts))
        if run.get("other_run_ids"):
            lines.append(
                f"  NOTE: trace also contains records from "
                f"{len(run['other_run_ids'])} other run id(s): "
                f"{', '.join(run['other_run_ids'])}"
            )
    if meta:
        cfg = ", ".join(
            f"{k}={meta[k]}"
            for k in ("num_clients", "num_byzantine", "attack", "aggregator")
            if k in meta
        )
        if cfg:
            lines.append(f"run: {cfg}")
    spans = summary["spans"]
    base = spans.get("round", {}).get("total_s") or sum(
        s["total_s"] for p, s in spans.items() if "/" not in p
    )
    lines.append(
        f"{'span':<28}{'count':>7}{'total_s':>10}{'mean_ms':>10}{'max_ms':>10}"
        f"{'% round':>9}"
    )
    for path in sorted(spans, key=lambda p: -spans[p]["total_s"]):
        s = spans[path]
        pct = 100.0 * s["total_s"] / base if base else 0.0
        lines.append(
            f"{path:<28}{s['count']:>7}{s['total_s']:>10.3f}"
            f"{s['mean_s'] * 1e3:>10.1f}{s['max_s'] * 1e3:>10.1f}{pct:>9.1f}"
        )
    blk = summary.get("block") or {}
    if blk:
        lines.append(
            f"\nblock execution: {blk['blocks']} blocks x "
            f"~{blk['rounds_per_block']:.1f} rounds; per-round averages:"
        )
        for path, v in sorted(
            blk["per_round_mean_s"].items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"  {path:<26}{v * 1e3:>10.1f} ms/round")
    r = summary["rounds"]
    lines.append(
        f"\nrounds: {r['count']}  total {r['total_wall_s']:.3f}s  "
        f"mean {r['mean_wall_s'] * 1e3:.1f}ms"
    )
    c = summary["compiles"]
    if c["count"]:
        lines.append(
            f"compiles: {c['count']}  total {c['total_s']:.2f}s  "
            f"max {c['max_s']:.2f}s"
        )
    if summary["counters"]:
        pairs = ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(summary["counters"].items())
        )
        lines.append(f"counters: {pairs}")
    mem = summary.get("memory") or {}
    if mem:
        mb = mem["peak_update_bytes"] / 1e6
        extras = ", ".join(
            f"{k}={int(mem[k])}"
            for k in ("streaming", "client_chunks", "chunk_size")
            if k in mem
        )
        lines.append(
            f"memory: peak_update_bytes={mem['peak_update_bytes']:.0f} "
            f"({mb:.1f} MB{', ' + extras if extras else ''})"
        )
    disp = summary.get("dispatch") or {}
    if disp:
        lines.append(
            f"dispatch accounting: share={disp['dispatch_share']:.3f} "
            f"(host enqueue {disp['enqueue_s']:.3f}s vs device ready "
            f"{disp['ready_s']:.3f}s over {disp['launches']} launches)"
        )
        for kind, k in sorted((disp.get("by_kind") or {}).items()):
            n = k["rounds"] or 1
            lines.append(
                f"  {kind:<12} launches={k['launches']} rounds={k['rounds']} "
                f"enqueue={k['enqueue_s'] / n * 1e3:.1f}ms/rnd "
                f"ready={k['ready_s'] / n * 1e3:.1f}ms/rnd "
                f"share={k['dispatch_share']:.3f} "
                f"compile={k['compile_s']:.2f}s"
            )
    swp = summary.get("sweep") or {}
    for name, f in sorted(swp.items()):
        total = f" / {f['total']}" if f.get("total") is not None else ""
        lines.append(
            f"sweep[{name}]: {f['cells']}{total} cells, "
            f"{f['mean_cell_s'] * 1e3:.0f}ms/cell "
            f"(overhead {f['per_cell_overhead_s'] * 1e3:.0f}ms/cell, "
            f"compile {f['compile_s']:.2f}s of {f['wall_s']:.2f}s wall)"
        )
    svc = summary.get("service") or {}
    if svc:
        parts = [f"requests={svc.get('requests_finished', 0)}"]
        if "warm_requests" in svc:
            parts.append(
                f"warm={svc['warm_requests']} cold={svc['cold_requests']}"
            )
        if "queue_wait_share" in svc:
            parts.append(f"queue_wait_share={svc['queue_wait_share']:.3f}")
        if "warm_p99_s" in svc:
            parts.append(f"warm_p99={svc['warm_p99_s'] * 1e3:.0f}ms")
        if "queue_depth_hwm" in svc:
            parts.append(f"depth_hwm={svc['queue_depth_hwm']}")
        for key in ("served", "rejected", "quarantined_requests"):
            if key in svc:
                parts.append(f"{key}={svc[key]}")
        lines.append(f"service: {'  '.join(parts)}")
    progs = summary.get("programs") or {}
    for name, p in sorted(progs.items()):
        pairs = ", ".join(
            f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(p.items())
        )
        lines.append(f"program[{name}]: {pairs}")
    prov = summary.get("provenance") or {}
    if prov.get("by_fingerprint"):
        lines.append(
            f"\ncompile provenance: {prov['programs']} programs, "
            f"{prov['builds']} builds ({prov['cold']} cold), "
            f"{prov['build_s']:.2f}s trace+lower+compile"
        )
        lines.append(
            f"  {'program':<26}{'fingerprint':<16}{'builds':>7}{'warm':>6}"
            f"{'build_s':>9}  causes"
        )
        by_fp = prov["by_fingerprint"]
        for fp in sorted(by_fp, key=lambda f: -by_fp[f]["build_s"]):
            e = by_fp[fp]
            causes = ",".join(
                f"{k}x{v}" if v > 1 else k
                for k, v in sorted(e["causes"].items())
            )
            lines.append(
                f"  {e['program']:<26}{fp:<16}{e['builds']:>7}{e['warm']:>6}"
                f"{e['build_s']:>9.2f}  {causes}"
            )
        cache = prov.get("cache")
        if cache:
            pairs = ", ".join(f"{k}={v}" for k, v in sorted(cache.items()))
            lines.append(f"  engine cache: {pairs}")
    met = summary.get("metrics") or {}
    if met:
        pairs = ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(met.items())
        )
        lines.append(f"metrics: {pairs}")
    hb = summary.get("heartbeat") or {}
    if hb:
        pairs = ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(hb.items())
        )
        lines.append(f"heartbeat: {pairs}")
        if hb.get("warnings"):
            # the emission threshold lives with the emitter (stdlib-safe
            # import) — the hint must not drift from what triggered it;
            # fall back to the shipped value when run standalone outside
            # the repo root
            try:
                from blades_tpu_torch.supervision.heartbeat import MARGIN_WARN_FRAC
            except ImportError:
                MARGIN_WARN_FRAC = 0.75
            lines.append(
                f"  WARNING: {hb['warnings']} beat(s) landed within "
                f"{(1 - MARGIN_WARN_FRAC) * 100:.0f}% of the supervisor "
                f"timeout (min margin {hb['min_margin_s']:.1f}s) — raise "
                "--heartbeat-timeout or shrink the block"
            )
    if summary["defense"]:
        pairs = ", ".join(
            f"{k}={v:.3f}" for k, v in sorted(summary["defense"].items())
        )
        lines.append(f"defense: {pairs}")
    aud = summary.get("audit") or {}
    if aud:
        pairs = ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(aud.items())
        )
        lines.append(f"audit: {pairs}")
    asy = summary.get("async") or {}
    if asy:
        pairs = ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(asy.items())
        )
        lines.append(f"async: {pairs}")
    al = summary.get("alerts") or {}
    if al:
        sev = ", ".join(
            f"{k}={v}" for k, v in sorted(al.get("by_severity", {}).items())
        )
        lines.append(
            f"ALERTS: {al['count']} ({sev}): {', '.join(al.get('rules', []))}"
        )
        fc = al.get("first_critical")
        if fc:
            lines.append(f"  first critical: {fc.get('message')}")
    sup = summary.get("supervisor") or {}
    if sup.get("events"):
        pairs = ", ".join(f"{k}={v}" for k, v in sorted(sup["events"].items()))
        lines.append(f"supervisor: {pairs}")
        if sup["kill_reasons"]:
            lines.append(f"  kill reasons: {', '.join(sup['kill_reasons'])}")
    return "\n".join(lines)


def compare_format(sa: dict, sb: dict, la: str = "A", lb: str = "B") -> str:
    """Side-by-side per-stage cost + counter diff of two runs — the
    workflow every perf PR so far ran by eyeballing two terminals."""
    lines = []
    lines.append(f"A = {la}")
    lines.append(f"B = {lb}")
    for label, s in (("A", sa), ("B", sb)):
        run = s.get("run") or {}
        if run.get("run_id"):
            fp = run.get("config_fingerprint")
            lines.append(
                f"  {label}: run_id {run['run_id']}"
                + (f"  config {fp}" if fp else "")
            )
    for label, s in (("A", sa), ("B", sb)):
        al = s.get("alerts") or {}
        if al:
            lines.append(
                f"  {label}: ALERTS {al['count']}: "
                f"{', '.join(al.get('rules', []))}"
            )
    ra, rb = sa["rounds"], sb["rounds"]
    lines.append(
        f"{'':<28}{'A':>12}{'B':>12}{'B/A':>8}\n"
        f"{'rounds':<28}{ra['count']:>12}{rb['count']:>12}"
    )

    def ratio(a, b):
        return f"{b / a:>8.2f}" if a else f"{'—':>8}"

    lines.append(
        f"{'mean round wall (ms)':<28}{ra['mean_wall_s'] * 1e3:>12.1f}"
        f"{rb['mean_wall_s'] * 1e3:>12.1f}"
        f"{ratio(ra['mean_wall_s'], rb['mean_wall_s'])}"
    )
    # per-stage: per-ROUND mean seconds so block-vs-round traces compare
    paths = sorted(set(sa["spans"]) | set(sb["spans"]))

    def per_round(s, path):
        sp = s["spans"].get(path)
        n = s["rounds"]["count"] or 1
        return sp["total_s"] / n if sp else None

    for path in paths:
        va, vb = per_round(sa, path), per_round(sb, path)
        fa = f"{va * 1e3:>12.1f}" if va is not None else f"{'—':>12}"
        fb = f"{vb * 1e3:>12.1f}" if vb is not None else f"{'—':>12}"
        rr = ratio(va, vb) if va is not None and vb is not None else f"{'—':>8}"
        lines.append(f"{path + ' (ms/rnd)':<28}{fa}{fb}{rr}")
    keys = sorted(set(sa["counters"]) | set(sb["counters"]))
    for k in keys:
        va, vb = sa["counters"].get(k, 0), sb["counters"].get(k, 0)
        fmt = (
            (lambda v: f"{v:>12.3f}")
            if isinstance(va, float) or isinstance(vb, float)
            else (lambda v: f"{v:>12}")
        )
        lines.append(f"{k:<28}{fmt(va)}{fmt(vb)}{ratio(va, vb)}")
    ca, cb = sa["compiles"], sb["compiles"]
    lines.append(
        f"{'compiles':<28}{ca['count']:>12}{cb['count']:>12}"
        f"{ratio(ca['count'], cb['count'])}"
    )
    ma = (sa.get("memory") or {}).get("peak_update_bytes")
    mb = (sb.get("memory") or {}).get("peak_update_bytes")
    if ma is not None or mb is not None:
        fa = f"{ma:>12.0f}" if ma is not None else f"{'—':>12}"
        fb = f"{mb:>12.0f}" if mb is not None else f"{'—':>12}"
        rr = ratio(ma, mb) if ma and mb is not None else f"{'—':>8}"
        lines.append(f"{'peak_update_bytes':<28}{fa}{fb}{rr}")
    # dispatch accounting: per-round enqueue/ready + the share itself —
    # the diff every dispatch-bound-claim PR must show moving
    da, db = sa.get("dispatch") or {}, sb.get("dispatch") or {}
    if da or db:
        na = (sa["rounds"]["count"] or 1)
        nb = (sb["rounds"]["count"] or 1)
        for key, label in (("enqueue_s", "dispatch enqueue (ms/rnd)"),
                           ("ready_s", "dispatch ready (ms/rnd)")):
            va = da.get(key, 0.0) / na if da else None
            vb = db.get(key, 0.0) / nb if db else None
            fa = f"{va * 1e3:>12.1f}" if va is not None else f"{'—':>12}"
            fb = f"{vb * 1e3:>12.1f}" if vb is not None else f"{'—':>12}"
            rr = ratio(va, vb) if va is not None and vb is not None else f"{'—':>8}"
            lines.append(f"{label:<28}{fa}{fb}{rr}")
        va = da.get("dispatch_share") if da else None
        vb = db.get("dispatch_share") if db else None
        fa = f"{va:>12.3f}" if va is not None else f"{'—':>12}"
        fb = f"{vb:>12.3f}" if vb is not None else f"{'—':>12}"
        rr = ratio(va, vb) if va is not None and vb is not None else f"{'—':>8}"
        lines.append(f"{'dispatch_share':<28}{fa}{fb}{rr}")
    # serving-path accounting: warm p99 + queue-wait share — the rows a
    # scheduling/serving PR must show moving
    va_s, vb_s = sa.get("service") or {}, sb.get("service") or {}
    if va_s or vb_s:
        for key, label, scale in (
            ("warm_p99_s", "service warm p99 (ms)", 1e3),
            ("total_p99_s", "service total p99 (ms)", 1e3),
            ("queue_wait_share", "service queue_wait_share", 1.0),
        ):
            va, vb = va_s.get(key), vb_s.get(key)
            if va is None and vb is None:
                continue
            fmt = (lambda v: f"{v * scale:>12.1f}") if scale != 1.0 else (
                lambda v: f"{v:>12.3f}")
            fa = fmt(va) if va is not None else f"{'—':>12}"
            fb = fmt(vb) if vb is not None else f"{'—':>12}"
            rr = ratio(va, vb) if va is not None and vb is not None else f"{'—':>8}"
            lines.append(f"{label:<28}{fa}{fb}{rr}")
    # sweep accounting: per-cell wall + build overhead per family
    wa, wb = sa.get("sweep") or {}, sb.get("sweep") or {}
    for fam in sorted(set(wa) | set(wb)):
        for key, label in (
            ("mean_cell_s", f"sweep[{fam}] cell (ms)"),
            ("per_cell_overhead_s", f"sweep[{fam}] overhead (ms)"),
        ):
            va = (wa.get(fam) or {}).get(key)
            vb = (wb.get(fam) or {}).get(key)
            fa = f"{va * 1e3:>12.1f}" if va is not None else f"{'—':>12}"
            fb = f"{vb * 1e3:>12.1f}" if vb is not None else f"{'—':>12}"
            rr = ratio(va, vb) if va is not None and vb is not None else f"{'—':>8}"
            lines.append(f"{label:<28}{fa}{fb}{rr}")
    # compile-provenance program-set diff (schema v7 `program` records):
    # which programs one run built that the other didn't, and the cost.
    # Traces predating v7 have no provenance section — diff what exists
    # and say so ONCE instead of failing (cross-schema-version contract).
    pa = (sa.get("provenance") or {}).get("by_fingerprint")
    pb = (sb.get("provenance") or {}).get("by_fingerprint")
    if pa is None and pb is None:
        pass  # both traces predate program records: nothing to diff
    elif pa is None or pb is None:
        missing = "A" if pa is None else "B"
        lines.append(
            f"NOTE: trace {missing} has no `program` records (predates "
            "schema v7 compile provenance) — program-set diff skipped"
        )
    else:
        both = sorted(set(pa) | set(pb))
        builds_a = sum(e["builds"] for e in pa.values())
        builds_b = sum(e["builds"] for e in pb.values())
        lines.append(
            f"{'program builds':<28}{builds_a:>12}{builds_b:>12}"
            f"{ratio(builds_a, builds_b)}"
        )
        va = sum(e["build_s"] for e in pa.values())
        vb = sum(e["build_s"] for e in pb.values())
        lines.append(
            f"{'program build_s':<28}{va:>12.2f}{vb:>12.2f}{ratio(va, vb)}"
        )
        only_a = [fp for fp in both if fp in pa and fp not in pb]
        only_b = [fp for fp in both if fp in pb and fp not in pa]
        for label, only, side in (("only in A", only_a, pa),
                                  ("only in B", only_b, pb)):
            if not only:
                continue
            cost = sum(side[fp]["build_s"] for fp in only)
            names = ", ".join(
                f"{side[fp]['program']}[{fp[:12]}]"
                for fp in sorted(only, key=lambda f: -side[f]["build_s"])[:5]
            )
            more = f" (+{len(only) - 5} more)" if len(only) > 5 else ""
            lines.append(
                f"  programs {label}: {len(only)} costing {cost:.2f}s — "
                f"{names}{more}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", nargs="+",
                   help="path to a telemetry .jsonl file (two with --compare)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the summary dict as JSON instead of a table")
    p.add_argument("--compare", action="store_true",
                   help="diff two traces' cost tables and counters "
                        "side by side")
    p.add_argument("--force", action="store_true",
                   help="compare traces even when their config fingerprints "
                        "differ (default: refuse — a diff of two different "
                        "experiments is noise dressed as signal)")
    args = p.parse_args(argv)
    if args.compare:
        if len(args.trace) != 2:
            print("--compare needs exactly two trace paths", file=sys.stderr)
            return 2
        summaries = []
        for path in args.trace:
            records = load_records(path)
            if not records:
                print(f"no records in {path}", file=sys.stderr)
                return 1
            summaries.append(summarize(records))
        # config-fingerprint guard (telemetry/ledger.py): the same
        # experiment hashes to the same fingerprint, so a mismatch means
        # the diff would compare unrelated runs. Refuse unless --force;
        # traces predating the fingerprint (either side missing) only warn.
        fps = [
            (s.get("run") or {}).get("config_fingerprint") for s in summaries
        ]
        if fps[0] and fps[1] and fps[0] != fps[1]:
            msg = (
                f"config fingerprints differ: A={fps[0]} B={fps[1]} — "
                "these traces are from different experiment configs"
            )
            if not args.force:
                print(f"REFUSING to compare: {msg} (use --force to override)",
                      file=sys.stderr)
                return 2
            print(f"WARNING: {msg} (--force given, comparing anyway)",
                  file=sys.stderr)
        elif not (fps[0] and fps[1]):
            print("WARNING: config fingerprint missing from "
                  + ("both traces" if not (fps[0] or fps[1])
                     else ("trace A" if not fps[0] else "trace B"))
                  + " (pre-run-identity trace?) — cannot verify the runs "
                    "share one experiment config", file=sys.stderr)
        if args.as_json:
            print(json.dumps({"a": summaries[0], "b": summaries[1]}))
        else:
            print(compare_format(*summaries, la=args.trace[0],
                                 lb=args.trace[1]))
        return 0
    if len(args.trace) != 1:
        print("exactly one trace path expected (or use --compare A B)",
              file=sys.stderr)
        return 2
    records = load_records(args.trace[0])
    if not records:
        print(f"no records in {args.trace[0]}", file=sys.stderr)
        return 1
    summary = summarize(records)
    if args.as_json:
        print(json.dumps(summary))
    else:
        print(format_table(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
