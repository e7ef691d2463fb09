"""Telemetry schema lint: validate a trace against the committed schema.

Counterpart: ``blades_tpu/telemetry/schema.py`` (copied). The schema is the
port's own copy, ``telemetry_schema.json`` beside this module, of the JAX
package's ``docs/telemetry_schema.json`` (a test holds the two equal): the
port reads no file of the JAX tree. An unknown record type or an
undeclared field on a closed (``"extra": false``) type is an error.

Stdlib only. Usage::

    python -m blades_tpu_torch.telemetry.schema <trace.jsonl>   # exit 1 on drift
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

#: The port's copy of the schema.
SCHEMA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "telemetry_schema.json")

_CHECKS = {
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "string": lambda v: isinstance(v, str),
    "bool": lambda v: isinstance(v, bool),
    "array": lambda v: isinstance(v, list),
    "object": lambda v: isinstance(v, dict),
}


def load_schema(path: Optional[str] = None) -> Dict[str, Any]:
    with open(path or SCHEMA_PATH) as f:
        return json.load(f)


def validate_record(rec: Dict[str, Any], schema: Dict[str, Any]) -> List[str]:
    """Errors for one parsed record (empty list == valid).

    The schema's top-level ``envelope`` declares the run-identity fields
    the recorder stamps onto every record: implicitly optional on every
    type, closed ones included, but still type-checked."""
    t = rec.get("t")
    if not isinstance(t, str):
        return [f"record has no string 't' field: {rec!r:.120}"]
    spec = schema["types"].get(t)
    if spec is None:
        return [f"unknown record type {t!r}: add it to the telemetry schema"]
    errors = []
    envelope = schema.get("envelope", {})
    for field, ftype in envelope.items():
        # an envelope name shadowed by the type's own declaration is
        # validated by that declaration below
        if (field in rec and field not in spec.get("required", {})
                and field not in spec.get("optional", {}) and not _CHECKS[ftype](rec[field])):
            errors.append(f"{t}.{field}: envelope field expected {ftype}, got "
                          f"{type(rec[field]).__name__} ({rec[field]!r:.60})")
    for field, ftype in spec.get("required", {}).items():
        if field not in rec:
            errors.append(f"{t}: missing required field {field!r}")
        elif not _CHECKS[ftype](rec[field]):
            errors.append(f"{t}.{field}: expected {ftype}, got "
                          f"{type(rec[field]).__name__} ({rec[field]!r:.60})")
    for field, ftype in spec.get("optional", {}).items():
        if field in rec and not _CHECKS[ftype](rec[field]):
            errors.append(f"{t}.{field}: expected {ftype}, got "
                          f"{type(rec[field]).__name__} ({rec[field]!r:.60})")
    if not spec.get("extra", True):
        declared = ({"t"} | set(envelope) | set(spec.get("required", {}))
                    | set(spec.get("optional", {})))
        for field in rec:
            if field not in declared:
                errors.append(f"{t}: undeclared field {field!r} on a closed type")
    return errors


def validate_records(records, schema: Optional[Dict[str, Any]] = None) -> List[str]:
    """Errors across a record list, each prefixed with its index."""
    schema = schema or load_schema()
    errors = []
    for i, rec in enumerate(records):
        for e in validate_record(rec, schema):
            errors.append(f"[{i}] {e}")
    return errors


def load_trace(path: str) -> list:
    """The records of a telemetry.jsonl file; blank and torn lines (a live
    run may be mid-write) are skipped."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return records


def validate_trace(path: str, schema: Optional[Dict[str, Any]] = None) -> List[str]:
    """Errors for a telemetry.jsonl file; a trace with no parseable record
    is an error too (a lint that validates nothing must not pass)."""
    records = load_trace(path)
    if not records:
        return [f"no parseable JSONL records in {path}"]
    return validate_records(records, schema)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", help="path to a telemetry .jsonl file")
    p.add_argument("--schema", default=None, help="override schema path")
    args = p.parse_args(argv)
    errors = validate_trace(args.trace, load_schema(args.schema))
    if errors:
        for e in errors:
            print(e)
        print(f"{len(errors)} schema violation(s) in {args.trace}")
        return 1
    print(f"{args.trace}: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
