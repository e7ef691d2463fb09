"""Request-path accounting: where a service request's wall clock goes.

Counterpart: ``blades_tpu/telemetry/reqpath.py``, copied but for what
counts as build work. **Per-request lifecycle** (:class:`RequestPath`):
monotonic stamps at each stage the server drives a request through,
``admitted`` -> ``spooled`` -> ``queued`` -> ``started`` -> the cells ->
finished, and at finish the split that tiles the request's wall::

    total_s = queue_wait_s + build_s + execute_s

- ``queue_wait_s``: admitted -> started, the wait behind other requests;
- ``build_s``: build work during execution, clamped to the window;
- ``execute_s``: the rest of the execution wall.

The JAX package counts XLA's trace and compile seconds as build work. The
port compiles no XLA program; its build work is what the process's build
counters (``telemetry/recorder.py:PROCESS_COUNTER_NAMES``) and the engine
cache record: a kernel library built by ``nvcc``, a CUDA graph captured,
an engine built on an ``EngineCache`` miss (:func:`build_counters` adds
the cache's totals to the process counters; the server passes them to
:meth:`RequestPath.start` and :meth:`MetricsRegistry.finish`). A request
that paid none of these is ``warm``; ``compiles`` on its record counts the
builds it paid.

**Rolling serving metrics** (:class:`MetricsRegistry`): every finished
or rejected request folds in: fixed-bin latency :class:`Histogram` s
(total / warm / cold / queue wait) with p50 / p90 / p99, counters by op
and by client, retried and quarantined cells, the queue-depth high-water
marks. :meth:`MetricsRegistry.snapshot` is the ``op: metrics`` reply and
the ``metrics_snapshot`` record of ``service_trace.jsonl``.

The bins are a fixed 1-2-5 ladder from 1 ms to 10,000 s; a percentile is
the upper edge of the bin holding the rank-``ceil(q*n)`` observation (the
overflow bin reports the observed maximum), so a tail is never
underestimated and memory stays O(bins). Clocks are injectable; the
registry is thread-safe (the listener thread answers ``op: metrics``
while the executing thread folds finishes). Stdlib only.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Dict, Optional

from blades_tpu_torch.telemetry import recorder as _recorder

__all__ = ["Histogram", "RequestPath", "MetricsRegistry", "STAGES", "build_counters"]

#: Lifecycle stages in server order (``finish`` closes the path).
STAGES = ("admitted", "spooled", "queued", "started")

#: The counters that make up build work, and the counts of builds that
#: make a request cold: a kernel library built by ``nvcc``
#: (``ops/_build.py``), a CUDA graph captured (``core/graphs.py``), and an
#: engine built on an ``EngineCache`` miss (``engine.*``, from the cache's
#: own totals: :func:`build_counters`).
_BUILD_SECONDS_KEYS = ("cuda.kernel_build_s", "cuda.graph_capture_s", "engine.build_s")
_BUILD_COUNT_KEYS = ("cuda.kernel_builds", "cuda.graph_captures", "engine.builds")


def build_counters(cache=None) -> Dict[str, float]:
    """The process's build counters (``telemetry/recorder.py``) with an
    ``EngineCache``'s build totals as ``engine.builds`` /
    ``engine.build_s``: what :meth:`RequestPath.start` and
    :meth:`RequestPath.finish` take the delta of."""
    out = dict(_recorder.process_counters())
    if cache is not None:
        out["engine.builds"] = float(cache.builds)
        out["engine.build_s"] = float(cache.build_s)
    return out


class Histogram:
    """Fixed-bin latency histogram with conservative exact-edge
    percentiles (see the module docstring for the contract)."""

    #: 1-2-5 ladder, 1 ms → 10^4 s. Bin i holds values v with
    #: ``EDGES[i-1] < v <= EDGES[i]`` (bin 0: ``v <= EDGES[0]``); one
    #: overflow bin beyond the last edge.
    EDGES = tuple(
        m * (10.0 ** e) for e in range(-3, 4) for m in (1.0, 2.0, 5.0)
    ) + (10000.0,)

    __slots__ = ("counts", "count", "total", "vmax")

    def __init__(self):
        self.counts = [0] * (len(self.EDGES) + 1)
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        if v != v or v < 0.0:  # NaN/negative: clock skew, not a latency
            v = 0.0
        # first bin whose upper edge holds v (v <= EDGES[i]); past the
        # last edge lands in the overflow bin
        self.counts[bisect.bisect_left(self.EDGES, v)] += 1
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    def percentile(self, q: float) -> Optional[float]:
        """The upper edge of the bin holding the ``ceil(q * count)``-th
        observation (observed max for the overflow bin); None when
        empty."""
        if not self.count:
            return None
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.EDGES[i] if i < len(self.EDGES) else self.vmax
        return self.vmax

    def to_dict(self) -> Dict[str, Any]:
        """The snapshot sub-dict (empty histogram reports count 0 only)."""
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "mean_s": round(self.total / self.count, 6),
            "p50_s": self.percentile(0.50),
            "p90_s": self.percentile(0.90),
            "p99_s": self.percentile(0.99),
            "max_s": round(self.vmax, 6),
        }


class RequestPath:
    """Lifecycle stamps + derived wall split for ONE request.

    ``priority`` is the scheduling class the request was admitted under
    (``blades_tpu_torch/service/scheduler.py``); a preempted request keeps ONE
    path across its execution slices — first-wins stamps mean queue-wait
    measures the original admission-to-first-start wait, and the build
    snapshot is re-taken per slice so the finish delta attributes the
    final slice's build work (slice-local build seconds of earlier
    slices are already folded into the per-cell ``sweep`` records)."""

    __slots__ = (
        "request_id", "op", "client", "priority", "stamps", "cells",
        "_clock", "_counters0",
    )

    def __init__(
        self,
        request_id: str,
        op: str = "?",
        client: str = "anon",
        priority: str = "normal",
        clock=time.monotonic,
    ):
        self.request_id = str(request_id)
        self.op = str(op)
        self.client = str(client)
        self.priority = str(priority)
        self._clock = clock
        self.stamps: Dict[str, float] = {"admitted": clock()}
        self.cells = 0
        self._counters0: Optional[Dict[str, float]] = None

    def stamp(self, stage: str) -> None:
        """Record a lifecycle stage once (first stamp wins — a resumed
        re-queue must not rewrite the original admission)."""
        self.stamps.setdefault(stage, self._clock())

    def start(self, counters: Optional[Dict[str, float]] = None) -> None:
        """The worker picked the request up: stamp ``started`` and
        snapshot the build counters, so the finish delta attributes only
        THIS request's build work."""
        self.stamp("started")
        self._counters0 = dict(
            _recorder.process_counters() if counters is None else counters
        )

    def cell(self) -> None:
        """One cell of this request completed (progress count only — the
        build/execute split is derived request-level at finish, where
        the build-counter delta covers runner setup the per-cell
        windows miss; per-cell walls live on the `sweep` records)."""
        self.cells += 1

    def age_s(self) -> float:
        """Seconds since admission (the in-flight/oldest-pending age)."""
        return self._clock() - self.stamps["admitted"]

    def finish(
        self, counters: Optional[Dict[str, float]] = None
    ) -> Dict[str, Any]:
        """Close the path; returns the split fields for the finished
        ``request`` record. ``queue_wait_s + build_s + execute_s``
        tiles ``total_s`` exactly (pre-rounding)."""
        now = self._clock()
        t_admitted = self.stamps["admitted"]
        t_started = self.stamps.get("started")
        if t_started is None:
            # never executed (rejected at the door / malformed): the
            # whole life was queue wait
            t_started = now
        queue_wait = max(0.0, t_started - t_admitted)
        wall = max(0.0, now - t_started)
        compiles = 0
        build = 0.0
        if self._counters0 is not None:
            counters = (
                _recorder.process_counters() if counters is None else counters
            )
            compiles = int(sum(
                counters.get(k, 0) - self._counters0.get(k, 0)
                for k in _BUILD_COUNT_KEYS
            ))
            build = sum(
                counters.get(k, 0.0) - self._counters0.get(k, 0.0)
                for k in _BUILD_SECONDS_KEYS
            )
            build = min(wall, max(0.0, build))
        execute = wall - build
        return {
            "queue_wait_s": round(queue_wait, 6),
            "build_s": round(build, 6),
            "execute_s": round(execute, 6),
            "total_s": round(queue_wait + wall, 6),
            "warm": compiles == 0,
            "compiles": compiles,
        }


def _bump(table: Dict[str, Dict[str, int]], key: str, field: str) -> None:
    row = table.setdefault(key, {})
    row[field] = row.get(field, 0) + 1


class MetricsRegistry:
    """Rolling serving metrics for one server process (thread-safe)."""

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._t0 = clock()
        self.open: Dict[str, RequestPath] = {}
        self.requests: Dict[str, int] = {
            "admitted": 0, "served": 0, "failed": 0, "rejected": 0,
            "quarantined": 0, "warm": 0, "cold": 0,
        }
        self.cells: Dict[str, int] = {"done": 0, "retried": 0,
                                      "quarantined": 0}
        self.rejected_by_reason: Dict[str, int] = {}
        self.by_op: Dict[str, Dict[str, int]] = {}
        self.by_client: Dict[str, Dict[str, int]] = {}
        self.queue_depth_hwm = 0
        #: per-priority-class queue-depth HWMs: a drained batch queue
        #: must not mask a backed-up interactive one
        self.queue_depth_by_class_hwm: Dict[str, int] = {}
        #: scheduler counters (blades_tpu_torch/service/scheduler.py):
        #: preemptions taken and admission verdicts by kind
        self.sched: Dict[str, Any] = {"preemptions": 0, "admission": {}}
        #: per-tenant latency histograms (total, warm) — the
        #: victim-tenant SLO numbers the contention gate reads; bounded
        #: by tenant count, not request count
        self._client_hists: Dict[str, Dict[str, Histogram]] = {}
        self.hist_total = Histogram()
        self.hist_warm = Histogram()
        self.hist_cold = Histogram()
        self.hist_queue_wait = Histogram()
        self.split: Dict[str, float] = {
            "queue_wait_s": 0.0, "build_s": 0.0, "execute_s": 0.0,
            "total_s": 0.0,
        }

    # -- lifecycle hooks -------------------------------------------------------

    def admit(
        self,
        request_id: str,
        op: str = "?",
        client: str = "anon",
        priority: str = "normal",
    ) -> RequestPath:
        """Open a path for one admitted request (stamps ``admitted``)."""
        path = RequestPath(request_id, op=op, client=client,
                           priority=priority, clock=self._clock)
        with self._lock:
            self.open[request_id] = path
            self.requests["admitted"] += 1
            _bump(self.by_op, path.op, "admitted")
            _bump(self.by_client, path.client, "admitted")
        return path

    def admission(self, verdict: str) -> None:
        """Count one admission-estimator verdict (``estimated`` /
        ``no_estimate`` / ``infeasible``) for the ``sched`` snapshot."""
        with self._lock:
            table = self.sched["admission"]
            table[verdict] = table.get(verdict, 0) + 1

    def preempted(self, request_id: str) -> None:
        """One cell-boundary preemption taken; the path stays OPEN (the
        request is requeued, not finished) and the preemption is charged
        to its tenant's row."""
        with self._lock:
            self.sched["preemptions"] += 1
            path = self.open.get(request_id)
            if path is not None:
                _bump(self.by_client, path.client, "preempted")

    def get(self, request_id: str) -> Optional[RequestPath]:
        with self._lock:
            return self.open.get(request_id)

    def reject(
        self, reason: str, op: str = "?", client: str = "anon"
    ) -> None:
        """One shed request (never admitted — no path exists)."""
        with self._lock:
            self.requests["rejected"] += 1
            self.rejected_by_reason[reason] = (
                self.rejected_by_reason.get(reason, 0) + 1
            )
            _bump(self.by_op, str(op), "rejected")
            _bump(self.by_client, str(client), "rejected")

    def queue_depth(
        self, depth: int, by_class: Optional[Dict[str, int]] = None
    ) -> None:
        with self._lock:
            if depth > self.queue_depth_hwm:
                self.queue_depth_hwm = int(depth)
            for cls, d in (by_class or {}).items():
                if d > self.queue_depth_by_class_hwm.get(cls, 0):
                    self.queue_depth_by_class_hwm[cls] = int(d)

    def cell(self, request_id: str) -> None:
        with self._lock:
            self.cells["done"] += 1
            path = self.open.get(request_id)
        if path is not None:
            path.cell()

    def finish(
        self,
        request_id: str,
        outcome: str = "ok",
        retried: int = 0,
        quarantined_cells: int = 0,
        counters: Optional[Dict[str, float]] = None,
    ) -> Dict[str, Any]:
        """Fold one finished request into the rolling metrics; returns
        the path's split fields (for the finished ``request`` record).
        Unknown ids return ``{}`` — accounting must never fail a
        request it did not see admitted."""
        with self._lock:
            path = self.open.pop(request_id, None)
        if path is None:
            return {}
        fields = path.finish(counters=counters)
        executed = "started" in path.stamps
        with self._lock:
            if outcome == "error":
                self.requests["failed"] += 1
                _bump(self.by_op, path.op, "failed")
                _bump(self.by_client, path.client, "failed")
            else:
                self.requests["served"] += 1
                _bump(self.by_op, path.op, "served")
                _bump(self.by_client, path.client, "served")
                if outcome == "quarantined":
                    self.requests["quarantined"] += 1
            client_hists = self._client_hists.setdefault(
                path.client, {"total": Histogram(), "warm": Histogram()}
            )
            client_hists["total"].observe(fields["total_s"])
            if executed:
                self.requests["warm" if fields["warm"] else "cold"] += 1
                (self.hist_warm if fields["warm"]
                 else self.hist_cold).observe(fields["total_s"])
                if fields["warm"]:
                    client_hists["warm"].observe(fields["total_s"])
            self.hist_total.observe(fields["total_s"])
            self.hist_queue_wait.observe(fields["queue_wait_s"])
            for k in ("queue_wait_s", "build_s", "execute_s", "total_s"):
                self.split[k] += fields[k]
            self.cells["retried"] += int(retried)
            self.cells["quarantined"] += int(quarantined_cells)
        return fields

    # -- reporting -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The rolling-metrics snapshot: the ``op: metrics`` reply body
        and (via the server's health cadence) the ``metrics_snapshot``
        record fields — exactly the schema-declared keys."""
        with self._lock:
            total = self.split["total_s"]
            split = {k: round(v, 6) for k, v in self.split.items()}
            split["queue_wait_share"] = (
                round(self.split["queue_wait_s"] / total, 6) if total else 0.0
            )
            split["build_share"] = (
                round(self.split["build_s"] / total, 6) if total else 0.0
            )
            return {
                "uptime_s": round(self._clock() - self._t0, 3),
                "requests": dict(self.requests),
                "cells": dict(self.cells),
                "queue": {
                    "depth_hwm": self.queue_depth_hwm,
                    **{
                        f"wait_{k}": v
                        for k, v in self.hist_queue_wait.to_dict().items()
                        if k != "count"
                    },
                },
                "latency": {
                    "total": self.hist_total.to_dict(),
                    "warm": self.hist_warm.to_dict(),
                    "cold": self.hist_cold.to_dict(),
                },
                "split": split,
                "rejected_by_reason": dict(self.rejected_by_reason),
                "by_op": {k: dict(v) for k, v in self.by_op.items()},
                "by_client": self._by_client_locked(),
                "sched": {
                    "preemptions": self.sched["preemptions"],
                    "admission": dict(self.sched["admission"]),
                    "queue_depth_by_class_hwm": dict(
                        self.queue_depth_by_class_hwm
                    ),
                },
            }

    def _by_client_locked(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant counter rows merged with per-tenant latency stats
        (``latency`` / ``warm_latency`` sub-dicts): the victim-tenant
        warm p99 the contention gate reads lives here."""
        out: Dict[str, Dict[str, Any]] = {
            k: dict(v) for k, v in self.by_client.items()
        }
        for client, hists in self._client_hists.items():
            row = out.setdefault(client, {})
            row["latency"] = hists["total"].to_dict()
            row["warm_latency"] = hists["warm"].to_dict()
        return out
