"""Round-level telemetry: nested spans, counters, gauges, the round's
forensics, and a JSONL trace.

Counterpart: ``blades_tpu/telemetry/__init__.py``. Every ``Simulator.run``
writes ``<log_path>/telemetry.jsonl``: where each round spends its time
(``round`` / ``sample`` / ``dispatch`` / ``sync`` / ``eval`` /
``checkpoint`` spans), one ``round`` record per round, and what the defense
decided (``defense``), the audit's certificates (``audit``), the in-round
metric pack (``metrics``), the fault and async counters (``faults``,
``async``). ``BLADES_TELEMETRY=0`` turns it off. The schema is
``telemetry_schema.json`` here (:mod:`.schema` validates a trace).

This package (recorder, schema, context) is stdlib only. The torch-using
parts are submodules not re-exported here: :mod:`.metric_pack` (the
in-round ``MetricPack``) and :mod:`.profiling` (``torch.profiler``
captures and CUDA memory gauges).
"""

from blades_tpu_torch.telemetry.recorder import (  # noqa: F401
    NULL_RECORDER,
    Recorder,
    get_recorder,
    set_recorder,
    telemetry_enabled,
)

__all__ = ["Recorder", "NULL_RECORDER", "get_recorder", "set_recorder", "telemetry_enabled"]
