"""``python -m blades_tpu_torch.analysis`` — the port's static-analysis
gate.

Counterpart: ``blades_tpu/analysis/__main__.py:45-166``, copied with the
port's device option. One-JSON-line contract: stdout carries exactly one
parseable JSON line, with JAX's keys (per-rule violation counts, the
waiver counts and the Tier-B check results); human-readable violation
detail goes to stderr. Exit 0 iff no unwaived violation.

::

    python -m blades_tpu_torch.analysis --check              # Tier A + Tier B
    python -m blades_tpu_torch.analysis --check --tier a     # lints only, no torch
    python -m blades_tpu_torch.analysis --check --tier b --device cpu

``--baseline`` names a committed waiver file (``{"waivers": ["RULE:path",
...]}``). Waived violations are counted and reported (never silent) but
do not fail the gate. ``--write-baseline`` emits the file for the current
violation set so the diff is reviewable.

Tier A is stdlib-only; Tier B (``--tier b``/``all``) imports torch and
runs the round programs on ``--device`` (the card by default; without
CUDA that raises, and the JSON line carries the error).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

METRIC = "static_analysis"
REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _waiver_key(v) -> str:
    return f"{v.rule}:{v.path}"


def _run(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m blades_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    p.add_argument("--check", action="store_true",
                   help="run the gate (the only mode; kept explicit so the "
                        "call site reads like the other gates)")
    p.add_argument("--tier", choices=("a", "b", "all"), default="all",
                   help="a: AST lints only (stdlib, no torch); b: round-"
                        "program audit only; all (default): both")
    p.add_argument("--root", default=REPO, help="repo root to lint")
    p.add_argument("--baseline", default=None,
                   help="committed waiver file: {'waivers': ['RULE:path', ...]}")
    p.add_argument("--write-baseline", action="store_true",
                   help="write --baseline (or stdout-adjacent default) from "
                        "the current violations and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the active rule table to stderr")
    p.add_argument("--device", default="cuda",
                   help="device of the Tier-B programs (default: the card)")
    args = p.parse_args(argv)

    from blades_tpu_torch.analysis import RepoIndex, all_rules, run_rules

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id} [{r.severity}] {r.rationale}", file=sys.stderr)
        if not args.check:
            # listing alone must not pay for the gate (Tier B runs the
            # real round programs)
            print(json.dumps({
                "metric": METRIC, "rules_listed": len(rules), "ok": True,
            }))
            return 0

    summary = {
        "metric": METRIC,
        "root": os.path.abspath(args.root),
        "tier": args.tier,
        "rules": {},
        "files": 0,
    }
    violations = []
    waived_pragma = []
    if args.tier in ("a", "all"):
        index = RepoIndex(args.root)
        violations, waived_pragma = run_rules(index, rules)
        summary["files"] = len(index.files)
        summary["rules"] = {r.id: 0 for r in rules}
        for v in violations:
            summary["rules"][v.rule] = summary["rules"].get(v.rule, 0) + 1

    # baseline waivers: RULE:path keys, committed and diffed — never silent
    baseline_waived = []
    if args.baseline and os.path.exists(args.baseline) and not args.write_baseline:
        with open(args.baseline) as f:
            waivers = set(json.load(f).get("waivers", []))
        still = []
        for v in violations:
            (baseline_waived if _waiver_key(v) in waivers else still).append(v)
        violations = still
        for v in baseline_waived:
            summary["rules"][v.rule] -= 1

    if args.write_baseline:
        path = args.baseline or os.path.join(
            args.root, "results", "analysis", "baseline.json"
        )
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"waivers": sorted({_waiver_key(v) for v in violations})},
                f, indent=1, sort_keys=True,
            )
            f.write("\n")
        summary["baseline_written"] = os.path.relpath(path, args.root)

    tier_b = None
    if args.tier in ("b", "all") and not args.write_baseline:
        from blades_tpu_torch.analysis.program_audit import run_tier_b

        tier_b = run_tier_b(device=args.device)
        summary["tier_b"] = {
            "checks": len(tier_b["checks"]),
            "programs": tier_b["programs"],
            "failed": [
                f"{c['program']}/{c['check']}"
                for c in tier_b["checks"]
                if c["ok"] is False
            ],
        }

    for v in violations:
        print(str(v), file=sys.stderr)
    for v in waived_pragma:
        print(f"waived[pragma] {v}", file=sys.stderr)
    for v in baseline_waived:
        print(f"waived[baseline] {v}", file=sys.stderr)
    if tier_b is not None:
        for c in tier_b["checks"]:
            if c["ok"] is not True:
                state = "skipped" if c["ok"] is None else "failed"
                print(
                    f"tier-b {state} {c['program']}/{c['check']}: {c['detail']}",
                    file=sys.stderr,
                )

    summary["violations"] = len(violations)
    summary["waived_pragma"] = len(waived_pragma)
    summary["waived_baseline"] = len(baseline_waived)
    # --write-baseline succeeds by construction: recording the current
    # debt IS the requested outcome (the diff of the baseline file is the
    # review surface)
    summary["ok"] = bool(args.write_baseline) or (
        not violations and (tier_b is None or tier_b["ok"])
    )
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


def main(argv=None) -> int:
    """One-JSON-line contract, unconditionally: even a bug in the linter
    itself must reach the driver as a single parseable error line."""
    try:
        return _run(argv)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 - the contract IS the catch-all
        print(json.dumps({
            "metric": METRIC,
            "ok": False,
            "violations": None,
            "error": f"{type(e).__name__}: {e}"[:1000],
        }))
        return 1


if __name__ == "__main__":
    sys.exit(main())
