"""Defense certification: the contract battery and the breakdown matrix.

The port's counterpart of ``scripts/certify.py``: ``CERT_POOL`` (:61),
``build_aggregator`` (:73), ``total_cells`` (:84), ``enumerate_cells``
(:218), the cells' execution (``execute_cells`` :305-401, under
``sweeps.resilient.run_grouped_resilient``, or ``run_cells_resilient``
with each cell a group of its own under ``--sequential``),
``assemble_matrix`` (:408) with its headline check and quarantined rows,
and ``main`` (:607) with its sweep journal. Over the pooled defenses it
computes

1. the contract battery of each (``audit/contracts.py``): permutation
   invariance, translation equivariance, (f, c)-resilience, with the
   declared opt-outs (``Aggregator.audit_optouts``);
2. the breakdown matrix: each defense at each f in ``0..(K-1)//2`` under
   the adaptive search over the five templates (``audit/attack_search.py``),
   certified where the worst deviation is within ``c`` times the honest
   spread;
3. the staleness columns: the same search on the buffered-async server's
   weighted matrix, the byzantine rows reporting fresh (``fresh_byz``) or
   maximally stale (``stale_byz``);
4. the headline check: median, Krum and centered clipping certify at their
   nominal f, sync and in both staleness scenarios, and the mean fails at
   every f >= 1; ``ok`` in the summary says the matrix agrees.

Run it on the card, or on the CPU with ``--device cpu``::

    python -m blades_tpu_torch.examples.certify --device cpu --quick
    python -m blades_tpu_torch.examples.certify              # the card

It writes ``<out>/cert_matrix.json`` (``--out``, default
``results/certification_torch`` in the checkout, never the JAX package's
``results/certification``), a per-cell ``sweep`` trace
``<out>/sweep_trace.jsonl``, the sweep journal
``<out>/sweep_journal.jsonl``, and a ``started`` and a terminal record in
the run ledger (``telemetry/ledger.py``: ``BLADES_LEDGER``, by default
``results/ledger_torch.jsonl`` under the working directory). Standard
output is one JSON summary line, an error included; the exit code is 0
when ``ok``.

The cells run resiliently (``sweeps/resilient.py``): a failed group is
retried (``--attempts``, 2 by default), then bisected, and a cell that
still fails is quarantined, a row of ``quarantined_cells`` that makes
``ok`` false; ``--cell-deadline`` bounds each cell's execution (C cells
get C times it). Under ``BLADES_RESUME=1`` (a supervisor's relaunch) the
journaled cells are recovered and only the rest run; the journal's
fingerprint of the configuration keeps another configuration's cells out.
A dead CUDA context raises at once and quarantines nothing.

``--via-service`` (the simulation service, ``ROADMAP.md`` queue A, slice
13b) is not ported and raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.audit import (
    DEFAULT_C,
    DEFAULT_GRIDS,
    QUICK_GRIDS,
    battery_ctx,
    battery_kwargs,
    battery_search_inputs,
    nominal_f,
    resilience_from_cell,
    run_battery,
    staleness_row_weights,
    synthetic_honest,
)
from blades_tpu_torch.audit.attack_search import staleness_info
from blades_tpu_torch.core.engine import resolve_device
from blades_tpu_torch.sweeps import SweepCell, _execute_group, group_key, program_fingerprint
from blades_tpu_torch.sweeps.journal import SweepJournal
from blades_tpu_torch.sweeps.resilient import (
    ResilienceOptions,
    run_cells_resilient,
    run_grouped_resilient,
)
from blades_tpu_torch.supervision.heartbeat import RESUME_ENV
from blades_tpu_torch.telemetry import context, ledger, set_recorder, timeline
from blades_tpu_torch.utils import rng

REPO = Path(__file__).resolve().parents[2]
METRIC = "defense_certification"
DEFAULT_OUT = REPO / "results" / "certification_torch"

#: the certified pool (``scripts/certify.py:61``): the registry without the
#: async duplicate, ``clustering:distance`` as the intended-metric variant
CERT_POOL = (
    "mean", "median", "trimmedmean", "krum", "multikrum", "geomed",
    "autogm", "centeredclipping", "clustering", "clustering:distance",
    "clippedclustering", "fltrust", "dnc", "signguard", "asyncmean",
    "byzantinesgd",
)

#: the expectations the summary's ``ok`` asserts
HEADLINE_CERTIFY = ("median", "krum", "centeredclipping")
HEADLINE_FAIL = "mean"

#: the staleness scenarios of the async columns: (name, byzantine tau)
SCENARIOS = ("fresh_byz", "stale_byz")


def build_aggregator(name: str, k: int, f: int):
    """The defense of cell (name, f) at population ``k``; ``base:variant``
    sets the variant's ``metric``."""
    base, _, variant = name.partition(":")
    kwargs = battery_kwargs(base, k, f)
    if variant:
        kwargs["metric"] = variant
    return get_aggregator(base, **kwargs)


def total_cells(args) -> int:
    """The sweep's cell count: a battery cell per defense, a breakdown cell
    per (defense, f), and two staleness cells each unless ``--no-async``."""
    names = tuple(args.aggs) if args.aggs else CERT_POOL
    f_cells = (args.clients - 1) // 2 + 1
    per_f = 1 + (0 if args.no_async else 2)
    return len(names) * (1 + f_cells * per_f)


def sweep_inputs(seed: int, trials: int, k: int, d: int, device="cpu"):
    """``(trials_updates, ctx)`` of the breakdown and staleness cells: the
    ``[T, K, D]`` honest draws from a CPU generator at ``seed``, and the
    battery's context with its own CPU generator."""
    trials_updates = synthetic_honest(torch.Generator().manual_seed(int(seed)), trials, k, d,
                                      device=device)
    ctx = battery_ctx(None, k, d, generator=rng.generator(int(seed), 1, rng.AGG), device=device)
    return trials_updates, ctx


def _grids(args):
    return QUICK_GRIDS if args.quick else DEFAULT_GRIDS


def _cell_row(name, f, f_nom, cell, c, search_s) -> dict:
    return {
        "agg": name,
        "f": f,
        "nominal_f": f_nom,
        "worst_dev": round(cell["worst_dev"], 6),
        "worst_ratio": round(cell["worst_ratio"], 4),
        "rho": round(cell["rho"], 6),
        "certified": bool(cell["worst_ratio"] <= c),
        "within_nominal": f <= f_nom,
        "templates": {t: round(v["worst_ratio"], 4) for t, v in cell["templates"].items()},
        "search_s": round(search_s, 2),
    }


def _battery_entry(agg, f_nom, res) -> dict:
    # the instance's opt-outs: a variant (clustering's metric='distance')
    # shadows the class's set with its own
    optouts = dict(getattr(agg, "audit_optouts", {}) or {})
    return {
        "nominal_f": f_nom,
        "contracts": {
            cname: {"ok": r["ok"], "measured": r.get("residual", r.get("worst_ratio")),
                    "optout": optouts.get(cname)}
            for cname, r in res.items()
        },
    }


def enumerate_cells(args, device="cpu"):
    """Every search cell of the matrix as ``(plans, specs)``: ``specs`` the
    :class:`~blades_tpu_torch.sweeps.SweepCell` list, ``plans`` the
    parallel assembly directives ``(kind, name, agg, f_nom, f, extra)``,
    in the order of ``scripts/certify.py``."""
    k, d, trials = args.clients, args.dim, args.trials
    names = tuple(args.aggs) if args.aggs else CERT_POOL
    f_max = (k - 1) // 2
    trials_updates, ctx = sweep_inputs(args.seed, trials, k, d, device)
    scenarios = () if args.no_async else ((SCENARIOS[0], 0), (SCENARIOS[1], args.tau_max))
    specs, plans = [], []
    for name in names:
        base, _, _ = name.partition(":")
        f_nom = nominal_f(base, k)
        bat_agg = build_aggregator(name, k, max(1, f_nom))
        bat_trials, bat_f, bat_ctx = battery_search_inputs(
            bat_agg, k, d, trials=trials, seed=args.seed, name=base, device=device)
        plans.append(("battery", name, bat_agg, f_nom, None, None))
        specs.append(SweepCell(label=f"battery/{name}", agg=bat_agg, trials=bat_trials,
                               f=bat_f, ctx=bat_ctx))
        for f in range(f_max + 1):
            agg_f = build_aggregator(name, k, f)
            plans.append(("cell", name, agg_f, f_nom, f, None))
            specs.append(SweepCell(label=f"{name}/f{f}", agg=agg_f, trials=trials_updates,
                                   f=f, ctx=ctx))
            for scenario, tau_byz in scenarios:
                # the weighted matrix is the cell's data, prepared as
                # search_cell_staleness prepares it, so the async cells
                # group with the sync cells of the same defense
                mask, w, _ = staleness_row_weights(k, f, mode="polynomial", alpha=0.5,
                                                   tau_max=args.tau_max, tau_byz=tau_byz,
                                                   device=device)
                weighted = trials_updates * w[None, :, None]
                part = None if bool(mask.all()) else mask
                info = staleness_info(mask, w, f, mode="polynomial", alpha=0.5,
                                      tau_max=args.tau_max, tau_byz=tau_byz)
                plans.append(("async", name, agg_f, f_nom, f, (scenario, info)))
                specs.append(SweepCell(label=f"{name}/f{f}/{scenario}", agg=agg_f,
                                       trials=weighted, f=f, ctx=ctx, part_mask=part))
    return plans, specs


def execute_cells(args, plans, specs, sweep=None, journal=None, resilience=None):
    """The cells under the resilient executor: ``(results, walls, report)``,
    a quarantined cell's slot None. Grouped by program shape, or each cell
    a group of its own under ``--sequential`` (the same numbers).
    ``journal``: a :class:`~blades_tpu_torch.sweeps.journal.SweepJournal`
    whose cells are recovered, not run; ``resilience``: the
    :class:`~blades_tpu_torch.sweeps.resilient.ResilienceOptions` (by
    default from ``--attempts`` and ``--cell-deadline``). ``plans`` rides
    along as in ``scripts/certify.py``."""
    grids = _grids(args)
    if journal is not None and journal.resumed and sweep is not None:
        # the resume record leads the attempt's records: every later sweep
        # record without ``resumed`` is a cell this attempt ran
        recovered = journal.recovered([s.label for s in specs])
        sweep.resume(len(recovered), journal=journal.path,
                     quarantined=sum(journal.entry(lab) is None for lab in recovered))
    options = resilience or ResilienceOptions(
        attempts=getattr(args, "attempts", 2) or 2,
        cell_deadline_s=getattr(args, "cell_deadline", None))
    if getattr(args, "sequential", False):
        return run_cells_resilient(
            [(spec.label, spec) for spec in specs],
            lambda spec: _execute_group([spec], group_key(spec), grids=grids)[0],
            sweep=sweep, journal=journal, options=options, kind="certify")
    return run_grouped_resilient(specs, grids=grids, sweep=sweep, journal=journal,
                                 options=options)


def assemble_matrix(args, plans, specs, results, walls, report, device="cpu") -> dict:
    """The matrix from the executed cells, in the row order of ``scripts/certify.py``;
    runs each defense's contract battery on its executed resilience cell. A
    quarantined cell is a row of ``quarantined_cells`` (its error, never a
    result), which the headline checks skip and which makes ``ok`` false."""
    k, d, trials = args.clients, args.dim, args.trials
    c = args.c if args.c is not None else DEFAULT_C
    f_max = (k - 1) // 2
    names = tuple(args.aggs) if args.aggs else CERT_POOL
    qinfo = {q["cell"]: q for q in report.quarantined}
    battery, cells, async_cells, quarantined = {}, [], [], []
    for plan, spec, cell, wall in zip(plans, specs, results, walls):
        kind, name, agg, f_nom, f, extra = plan
        base, _, _ = name.partition(":")
        if cell is None:
            q = qinfo.get(spec.label, {})
            row = {"cell": spec.label, "kind": kind, "agg": name, "f": f,
                   "error": q.get("error", ""), "error_type": q.get("error_type", "Exception")}
            if q.get("batch"):
                row["batch"] = q["batch"]
            if kind == "async":
                row["scenario"] = extra[0]
            quarantined.append(row)
            continue
        if kind == "battery":
            res = run_battery(agg, k=k, d=d, f=max(1, f_nom), name=base, c=c, trials=trials,
                              seed=args.seed, grids=_grids(args),
                              resilience=resilience_from_cell(cell, spec.f, c), device=device)
            battery[name] = _battery_entry(agg, f_nom, res)
        elif kind == "cell":
            cells.append(_cell_row(name, f, f_nom, cell, c, wall))
        else:
            scenario, info = extra
            row = _cell_row(name, f, f_nom, cell, c, wall)
            row["scenario"] = scenario
            row["staleness"] = info
            async_cells.append(row)

    failures = []
    by = {(r["agg"], r["f"]): r for r in cells}
    a_by = {(r["agg"], r["f"], r["scenario"]): r for r in async_cells}
    for name in HEADLINE_CERTIFY:
        if not any(n.partition(":")[0] == name for n in names):
            continue
        for f in range(nominal_f(name, k) + 1):
            cell = by.get((name, f))
            if cell is not None and not cell["certified"]:
                failures.append(f"{name} fails at nominal f={f}")
            for scenario in SCENARIOS:
                acell = a_by.get((name, f, scenario))
                if acell is not None and not acell["certified"]:
                    failures.append(f"{name} fails at nominal f={f} under staleness "
                                    f"({scenario})")
    if HEADLINE_FAIL in names:
        for f in range(1, f_max + 1):
            cell = by.get((HEADLINE_FAIL, f))
            if cell is not None and cell["certified"]:
                failures.append(f"mean certifies at f={f} (must break)")
            acell = a_by.get((HEADLINE_FAIL, f, SCENARIOS[0]))
            if acell is not None and acell["certified"]:
                failures.append(f"mean certifies at f={f} under staleness (must break)")
    # the declared opt-outs must cover every battery failure
    for name, b in battery.items():
        for cname, r in b["contracts"].items():
            if not r["ok"] and not r["optout"]:
                failures.append(f"{name}: {cname} fails without an opt-out")
    return {
        "metric": METRIC,
        "clients": k,
        "dim": d,
        "trials": trials,
        "f_max": f_max,
        "c": c,
        "grids": "quick" if args.quick else "default",
        "batched": not getattr(args, "sequential", False),
        "seed": args.seed,
        "templates_per_cell": 5,
        "tau_max": args.tau_max,
        "device": str(device),
        "battery": battery,
        "cells": cells,
        "async_cells": async_cells,
        # a quarantined, retried or resumed sweep is not the evidence a
        # clean one is, and says so
        "quarantined_cells": quarantined,
        "resumed_skipped": report.resumed_skipped,
        "retried": report.retried,
        "degraded_groups": report.degraded_groups,
        "headline_failures": failures,
        "ok": not failures and not quarantined,
    }


def certify_matrix(args, sweep=None, device="cpu", journal=None, resilience=None) -> dict:
    """The whole matrix: enumerate, execute, assemble."""
    plans, specs = enumerate_cells(args, device)
    results, walls, report = execute_cells(args, plans, specs, sweep=sweep, journal=journal,
                                           resilience=resilience)
    return assemble_matrix(args, plans, specs, results, walls, report, device)


def journal_fingerprint(args, device) -> str:
    """The configuration a journal's cells belong to: a resume under
    another one starts fresh."""
    return program_fingerprint(
        kind="certify", clients=args.clients, dim=args.dim, trials=args.trials, seed=args.seed,
        c=args.c, quick=bool(args.quick), no_async=bool(args.no_async), tau_max=args.tau_max,
        aggs=sorted(args.aggs) if args.aggs else None, device=str(device))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--c", type=float, default=None,
                   help="resilience constant (default: audit.DEFAULT_C)")
    p.add_argument("--aggs", nargs="+", default=None,
                   help="a subset of the pool (default: the whole CERT_POOL)")
    p.add_argument("--quick", action="store_true", help="the reduced grids")
    p.add_argument("--no-async", action="store_true", help="skip the staleness columns")
    p.add_argument("--tau-max", type=int, default=3,
                   help="the honest staleness ladder's bound (rounds)")
    p.add_argument("--sequential", action="store_true",
                   help="one search call a cell instead of one a group (the same numbers)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--out", default=str(DEFAULT_OUT),
                   help="the directory of cert_matrix.json and sweep_trace.jsonl")
    p.add_argument("--attempts", type=int, default=2,
                   help="the retry budget of a batched group, and of an isolated cell before "
                        "its quarantine (sweeps/resilient.py)")
    p.add_argument("--cell-deadline", type=float, default=None,
                   help="a soft deadline a cell, in seconds (a group of C cells gets C times "
                        "it); a tripped deadline retries, then degrades")
    p.add_argument("--via-service", default=None, metavar="SOCK",
                   help="not ported: the simulation service is slice 13b")
    return p.parse_args(argv)


def _check_ported(args) -> None:
    if args.via_service is not None:
        raise NotImplementedError(
            "--via-service needs the simulation service, not ported to blades_tpu_torch yet "
            "(ROADMAP.md queue A, slice 13b)")
    unknown = [n for n in (args.aggs or ()) if n not in CERT_POOL]
    if unknown:
        raise ValueError(f"unknown aggregators {unknown}; the pool is {list(CERT_POOL)}")


def main(argv: Optional[List[str]] = None) -> int:
    """One JSON line on standard output whatever happens; 0 when ``ok``."""
    args = parse_args(argv)
    out = Path(args.out)
    sweep_trace = out / "sweep_trace.jsonl"
    context.activate(fresh=True)
    sweep = prev_recorder = entry = journal = None
    try:
        _check_ported(args)
        device = resolve_device(args.device)
        out.mkdir(parents=True, exist_ok=True)
        # under BLADES_RESUME=1 (a supervisor's relaunch) the journaled
        # cells are recovered and the trace goes on; otherwise both start
        # anew
        journal = SweepJournal(str(out / "sweep_journal.jsonl"),
                               fingerprint=journal_fingerprint(args, device),
                               resume=os.environ.get(RESUME_ENV) == "1")
        if not journal.resumed:
            try:
                sweep_trace.unlink()
            except OSError:
                pass
        sweep = timeline.SweepAccounting(
            "certify", total=total_cells(args), path=str(sweep_trace),
            meta={"clients": args.clients, "dim": args.dim, "quick": bool(args.quick),
                  "device": str(device)})
        # the search's own sweep records land in the same trace
        prev_recorder = set_recorder(sweep.rec)
        entry = ledger.run_started(
            "certify",
            config={"kind": "certify", "clients": args.clients, "dim": args.dim,
                    "trials": args.trials, "seed": args.seed, "quick": bool(args.quick),
                    "batched": not args.sequential, "device": str(device),
                    "aggs": sorted(args.aggs) if args.aggs else None},
            artifacts=[str(sweep_trace), journal.path])
        t0 = time.time()
        matrix = certify_matrix(args, sweep=sweep, device=device, journal=journal)
        matrix["wall_s"] = round(time.time() - t0, 1)
        matrix["resumed"] = journal.resumed
        artifact = out / "cert_matrix.json"
        with open(artifact, "w") as fh:
            json.dump(matrix, fh, indent=1)
            fh.write("\n")
        summary = {
            "metric": METRIC,
            "cells": len(matrix["cells"]),
            "aggregators": len(matrix["battery"]),
            "certified_cells": sum(r["certified"] for r in matrix["cells"]),
            "nominal_certified": sum(r["certified"] for r in matrix["cells"]
                                     if r["within_nominal"]),
            "nominal_cells": sum(r["within_nominal"] for r in matrix["cells"]),
            "async_cells": len(matrix["async_cells"]),
            "async_certified": sum(r["certified"] for r in matrix["async_cells"]),
            "headline_failures": matrix["headline_failures"],
            "wall_s": matrix["wall_s"],
            "device": str(device),
            "artifact": str(artifact),
            "sweep_cells": sweep.done,
            "sweep_trace": str(sweep_trace),
            "resumed": journal.resumed,
            "resumed_skipped": matrix["resumed_skipped"],
            "retried": matrix["retried"],
            "quarantined": [r["cell"] for r in matrix["quarantined_cells"]],
            "ok": matrix["ok"],
        }
        entry.ended("finished", metrics={"cells": summary["cells"],
                                         "certified_cells": summary["certified_cells"],
                                         "ok": summary["ok"]},
                    artifacts=[summary["artifact"], summary["sweep_trace"]])
        print(json.dumps(summary))
        return 0 if matrix["ok"] else 1
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 - the one-line contract is the catch-all
        if entry is not None:
            entry.ended("crashed", error=f"{type(e).__name__}: {e}")
        print(json.dumps({"metric": METRIC, "ok": False,
                          "error": f"{type(e).__name__}: {e}"[:1000]}))
        return 1
    finally:
        if prev_recorder is not None:
            set_recorder(prev_recorder)
        if sweep is not None:
            sweep.close()
        if journal is not None:
            journal.close()


if __name__ == "__main__":
    sys.exit(main())
