"""Multi-tenant request scheduling: priorities, fairness, admission cost.

Counterpart: ``blades_tpu/service/scheduler.py``, copied (the logic line
for line; the tests hold the two to equal picks, snapshots and verdicts).

- :class:`TenantScheduler`, the service's queue: **priority classes**
  (:data:`PRIORITIES`, highest first) run strictly before lower ones;
  **weighted per-tenant fair shares** within a class (each tenant's
  virtual time is its served seconds over its weight, the one furthest
  behind runs next); **per-tenant quotas**, so backpressure charges the
  tenant that overflowed; and **warm-first placement**: among a tenant's
  runnable requests, one whose affinity fingerprint already ran (its
  engines are built) goes first.
- **Preemption**: :meth:`TenantScheduler.waiting_above` is the
  ``should_yield`` hook the resilient executor polls at cell boundaries
  (:mod:`blades_tpu_torch.sweeps.resilient`); a batch request yields to
  an interactive one, is :meth:`~TenantScheduler.requeue`-d with its
  admission order, and its next slice recovers the journaled cells.
- :class:`CostEstimator`, deadline-aware admission: a warm cost a cell
  from the rolling split of ``telemetry/reqpath.py`` plus a cold-build
  surcharge from ``EngineCache.stats()["by_key"]``. No history estimates
  ``None``, and a cold start admits.

Under overload it rejects at the overflowing tenant's quota first, then
at the global bound (naming the deepest tenant), then infeasible
deadlines. Stdlib only: admission and the chaos drills run on probe-only
servers that never import torch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

__all__ = [
    "PRIORITIES",
    "CostEstimator",
    "ScheduledRequest",
    "TenantScheduler",
    "priority_rank",
]

#: Priority classes, highest first. ``interactive`` preempts running
#: batch work at cell boundaries; ``batch`` is the sweep drivers' class.
PRIORITIES = ("interactive", "normal", "batch")

_RANK = {name: i for i, name in enumerate(PRIORITIES)}


def priority_rank(priority: str) -> int:
    """Rank of a priority class (0 = highest); raises ``ValueError`` on
    an unknown class — admission must reject it, not default it."""
    try:
        return _RANK[priority]
    except KeyError:
        raise ValueError(
            f"unknown priority {priority!r} (supported: {PRIORITIES})"
        ) from None


@dataclasses.dataclass
class ScheduledRequest:
    """One queued request with everything scheduling needs: identity,
    tenant + class, the warm-affinity fingerprint, the admission cost
    estimate, and the FIFO sequence number that makes every tiebreak
    deterministic. ``waiter`` rides through untouched (the blocked
    submit connection, or ``None``)."""

    request_id: str
    request: Dict[str, Any]
    waiter: Any = None
    tenant: str = "anon"
    priority: str = "normal"
    affinity: Optional[str] = None
    est_s: Optional[float] = None
    seq: int = 0
    enqueued_ts: float = 0.0
    preemptions: int = 0

    @property
    def rank(self) -> int:
        return _RANK.get(self.priority, _RANK["normal"])


class TenantScheduler:
    """Priority + weighted-fair + warm-first queue (thread-safe).

    Parameters
    ----------
    max_queue : global bound on queued requests (in-flight excluded) —
        the global admission bound alone.
    tenant_quota : per-tenant bound; ``None`` disables per-tenant quotas
        (only the global bound applies — the pre-scheduler behavior).
    weights : per-tenant fair-share weights (default 1.0 each); a tenant
        with weight 2 accrues virtual time half as fast and is scheduled
        twice as often under contention.
    clock : injectable monotonic clock (tests).
    """

    def __init__(
        self,
        max_queue: int = 8,
        tenant_quota: Optional[int] = None,
        weights: Optional[Dict[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_queue = int(max_queue)
        self.tenant_quota = (
            int(tenant_quota) if tenant_quota is not None else None
        )
        self._weights = dict(weights or {})
        self._clock = clock
        self._cond = threading.Condition()
        self._entries: List[ScheduledRequest] = []
        self._seq = 0
        #: virtual time per tenant: served seconds / weight. The
        #: laggiest tenant schedules next within a class.
        self._vtime: Dict[str, float] = {}
        #: affinity fingerprint -> the worker ids (or the ``"inproc"``
        #: sentinel for the workers=0 path) whose PROCESS has executed
        #: that static config. Warmth is per-process: each worker owns
        #: its own ``EngineCache``, so a fingerprint warm on w0 is still
        #: cold on w1 — and a replaced worker's warmth dies with it.
        self._warm: Dict[str, Set[str]] = {}
        #: in-flight requests by id — one entry on the in-process path,
        #: up to W under the worker pool.
        self._in_flight: Dict[str, ScheduledRequest] = {}

    # -- admission -------------------------------------------------------------

    def overflow(self, tenant: str) -> Optional[Dict[str, Any]]:
        """Would admitting one request from ``tenant`` breach a bound?
        Returns ``None`` (admit) or a reject descriptor naming the
        tenant that overflowed: the submitter when ITS quota is full,
        the deepest-queued tenant when the global bound is hit — the
        flooder absorbs the blame (and, with quotas on, the
        rejections), never the victim."""
        with self._cond:
            per_tenant = sum(
                1 for e in self._entries if e.tenant == tenant
            )
            if (
                self.tenant_quota is not None
                and per_tenant >= self.tenant_quota
            ):
                return {
                    "reason": "backpressure",
                    "scope": "tenant",
                    "tenant": tenant,
                    "tenant_depth": per_tenant,
                    "tenant_quota": self.tenant_quota,
                }
            if len(self._entries) >= self.max_queue:
                depths: Dict[str, int] = {}
                for e in self._entries:
                    depths[e.tenant] = depths.get(e.tenant, 0) + 1
                blamed = max(
                    sorted(depths), key=lambda t: depths[t], default=tenant
                )
                return {
                    "reason": "backpressure",
                    "scope": "global",
                    "tenant": blamed,
                    "tenant_depth": depths.get(blamed, 0),
                    "queue_depth": len(self._entries),
                    "max_queue": self.max_queue,
                }
        return None

    def put(self, entry: ScheduledRequest) -> None:
        """Enqueue (no bound check — call :meth:`overflow` first; the
        listener is single-threaded, so check-then-put cannot race
        another admission)."""
        with self._cond:
            self._seq += 1
            if entry.seq <= 0:
                entry.seq = self._seq
            if entry.enqueued_ts <= 0:
                entry.enqueued_ts = self._clock()
            # a tenant waking from idle starts at the active floor: it
            # must not bank fairness credit while absent and then
            # monopolize the worker to "catch up"
            active = [
                self._vtime.get(e.tenant, 0.0) for e in self._entries
            ]
            floor = min(active) if active else 0.0
            self._vtime[entry.tenant] = max(
                self._vtime.get(entry.tenant, 0.0), floor
            )
            self._entries.append(entry)
            self._cond.notify()

    def requeue(self, entry: ScheduledRequest, preempted: bool = True) -> None:
        """Put a preempted (or worker-orphaned) request back. It keeps
        its original ``seq`` (head of its tenant's line, not the tail)
        and admission stamp; the preemption count advances only for a
        true preemption — a request requeued because its WORKER died was
        not preempted, it was orphaned."""
        with self._cond:
            if preempted:
                entry.preemptions += 1
            self._in_flight.pop(entry.request_id, None)
            self._entries.append(entry)
            self._cond.notify()

    # -- scheduling ------------------------------------------------------------

    def _warm_here(self, entry: ScheduledRequest, worker: Optional[str]) -> bool:
        """Is ``entry``'s affinity warm on the process that would run it?
        ``worker=None`` is the in-process path (``"inproc"`` sentinel)."""
        if not entry.affinity:
            return False
        procs = self._warm.get(entry.affinity)
        if not procs:
            return False
        return (worker if worker is not None else "inproc") in procs

    def _select_locked(
        self,
        worker: Optional[str] = None,
        warm_only: bool = False,
    ) -> Optional[ScheduledRequest]:
        if not self._entries:
            return None
        best_rank = min(e.rank for e in self._entries)
        candidates = [e for e in self._entries if e.rank == best_rank]
        by_tenant: Dict[str, List[ScheduledRequest]] = {}
        for e in candidates:
            by_tenant.setdefault(e.tenant, []).append(e)
        tenant = min(
            sorted(by_tenant),
            key=lambda t: (
                self._vtime.get(t, 0.0),
                min(e.seq for e in by_tenant[t]),
            ),
        )
        # warm-first within the tenant: a request whose affinity is
        # already warm ON THIS PROCESS runs before one that would
        # build cold, so cold builds batch at the line's tail instead
        # of interleaving with warm traffic. Under the pool, warmth is
        # per-worker — the fingerprint pin survives because repeats
        # route back to the process holding the built engines.
        chosen = min(
            by_tenant[tenant],
            key=lambda e: (
                0 if self._warm_here(e, worker) else 1,
                e.seq,
            ),
        )
        if warm_only and not self._warm_here(chosen, worker):
            # warm-affinity pass: only hand this worker a request it is
            # already warm for. Filtering AFTER priority/fair selection
            # keeps strict class order and tenant fairness intact — a
            # warm request never jumps a colder-but-laggier tenant.
            return None
        return chosen

    def pick(
        self,
        timeout: float,
        worker: Optional[str] = None,
        warm_only: bool = False,
    ) -> Optional[ScheduledRequest]:
        """Dequeue the next runnable request, blocking up to ``timeout``
        seconds; ``None`` on timeout (the worker's idle tick). ``worker``
        names the worker process the pick is for (warm-first routing);
        ``warm_only`` turns the pick into the dispatch loop's
        affinity pass — return a request only if this worker is warm
        for it."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            while True:
                entry = self._select_locked(worker, warm_only)
                if entry is not None:
                    self._entries.remove(entry)
                    self._in_flight[entry.request_id] = entry
                    return entry
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)

    def charge(self, tenant: str, cost_s: float) -> None:
        """Account one execution slice against ``tenant``'s fair share
        (preempted slices charge too — a tenant pays for the worker
        seconds it actually consumed)."""
        weight = max(1e-9, float(self._weights.get(tenant, 1.0)))
        with self._cond:
            self._vtime[tenant] = (
                self._vtime.get(tenant, 0.0) + max(0.0, cost_s) / weight
            )

    def done(self, entry: ScheduledRequest) -> None:
        """An in-flight request finished (reply spooled)."""
        with self._cond:
            self._in_flight.pop(entry.request_id, None)

    def waiting_above(self, priority: str) -> bool:
        """Is a strictly higher-priority request queued? The
        ``should_yield`` signal the resilient executor polls at cell
        boundaries."""
        rank = _RANK.get(priority, _RANK["normal"])
        with self._cond:
            return any(e.rank < rank for e in self._entries)

    # -- warm affinity ---------------------------------------------------------

    def note_warm(
        self, affinity: Optional[str], worker: Optional[str] = None
    ) -> None:
        """Record that ``affinity``'s programs are now warm on
        ``worker``'s process (``None`` = the in-process path)."""
        if affinity:
            with self._cond:
                self._warm.setdefault(affinity, set()).add(
                    worker if worker is not None else "inproc"
                )

    def forget_worker(self, worker: str) -> int:
        """Drop every warmth claim for a dead worker's process (its
        ``EngineCache`` died with it); returns how many fingerprints
        went cold for it."""
        dropped = 0
        with self._cond:
            for affinity in list(self._warm):
                procs = self._warm[affinity]
                if worker in procs:
                    procs.discard(worker)
                    dropped += 1
                    if not procs:
                        del self._warm[affinity]
        return dropped

    def is_warm(
        self, affinity: Optional[str], worker: Optional[str] = None
    ) -> bool:
        """Is ``affinity`` warm anywhere (``worker=None``: any process —
        the admission estimator's question) or on one specific worker?"""
        if not affinity:
            return False
        with self._cond:
            procs = self._warm.get(affinity)
            if not procs:
                return False
            return True if worker is None else worker in procs

    # -- introspection ---------------------------------------------------------

    def qsize(self) -> int:
        with self._cond:
            return len(self._entries)

    def empty(self) -> bool:
        return self.qsize() == 0

    def depth_by_class(self) -> Dict[str, int]:
        """Queued depth per priority class — every class always present,
        so a drained low-priority queue cannot mask a backed-up one
        (the per-class HWM gate's input)."""
        depths = {p: 0 for p in PRIORITIES}
        with self._cond:
            for e in self._entries:
                depths[PRIORITIES[e.rank]] += 1
        return depths

    def composition(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant queue composition for the health surface: depth,
        oldest-pending age, highest queued class — a starved tenant is
        attributable from this dict alone."""
        now = self._clock()
        out: Dict[str, Dict[str, Any]] = {}
        with self._cond:
            for e in self._entries:
                row = out.setdefault(e.tenant, {
                    "depth": 0,
                    "oldest_age_s": 0.0,
                    "priority": PRIORITIES[e.rank],
                })
                row["depth"] += 1
                row["oldest_age_s"] = round(
                    max(row["oldest_age_s"], now - e.enqueued_ts), 3
                )
                if e.rank < _RANK[row["priority"]]:
                    row["priority"] = PRIORITIES[e.rank]
        return out

    def backlog_s(self, priority: str) -> float:
        """Estimated seconds of work scheduled at or above ``priority``
        (queued estimates + the in-flight request's): what a new request
        of that class waits behind. Requests without an estimate
        contribute zero — the estimator stays advisory-optimistic, never
        a reason to reject on missing data."""
        rank = _RANK.get(priority, _RANK["normal"])
        with self._cond:
            total = sum(
                e.est_s or 0.0 for e in self._entries if e.rank <= rank
            )
            total += sum(
                e.est_s or 0.0 for e in self._in_flight.values()
            )
        return total


class CostEstimator:
    """Deadline-aware admission estimates from measured serving history.

    ``metrics_snapshot`` / ``cache_stats`` are callables returning the
    server's live :meth:`~blades_tpu_torch.telemetry.reqpath.MetricsRegistry
    .snapshot` and ``EngineCache.stats()`` (or ``None``) — injected so
    this module stays stdlib-only and unit-testable with dict fixtures.

    The estimate is deliberately simple and fully guarded: per-cell warm
    cost = executed seconds / cells done (the rolling split), plus — for a
    request whose affinity has not executed before — one cold-build
    surcharge = the mean per-fingerprint build time from the
    engine-cache stats (falling back to the rolling build split). With
    no completed cells there is NO estimate (:meth:`estimate` returns
    ``None``) and admission must admit: a cold-start server has no
    grounds to reject anything, and the per-cell deadline ladder remains
    the hard bound when the estimate is wrong.
    """

    def __init__(
        self,
        metrics_snapshot: Callable[[], Optional[Dict[str, Any]]],
        cache_stats: Callable[[], Optional[Dict[str, Any]]],
    ):
        self._metrics = metrics_snapshot
        self._cache = cache_stats

    def cold_build_s(self) -> float:
        """Mean per-fingerprint build cost from the engine-cache stats,
        falling back to the rolling build-seconds split per cold
        request; 0.0 when nothing has ever built."""
        stats = self._cache() or {}
        by_key = stats.get("by_key") or {}
        builds = [
            float(v.get("build_s") or 0.0)
            for v in by_key.values()
            if isinstance(v, dict) and v.get("build_s")
        ]
        if builds:
            return sum(builds) / len(builds)
        snap = self._metrics() or {}
        split = snap.get("split") or {}
        cold = (snap.get("requests") or {}).get("cold") or 0
        build = float(split.get("build_s") or 0.0)
        return build / cold if cold > 0 else 0.0

    def estimate(
        self, cells: int, warm: bool = False
    ) -> Optional[Dict[str, Any]]:
        """Estimated execution seconds for a request of ``cells`` cells,
        or ``None`` when there is no history to estimate from (cold
        start: must admit)."""
        snap = self._metrics() or {}
        done = int((snap.get("cells") or {}).get("done") or 0)
        if done <= 0 or cells <= 0:
            return None
        split = snap.get("split") or {}
        warm_cell = max(0.0, float(split.get("execute_s") or 0.0)) / done
        est = cells * warm_cell
        cold_build = 0.0
        if not warm:
            cold_build = self.cold_build_s()
            est += cold_build
        return {
            "est_s": round(est, 6),
            "warm_cell_s": round(warm_cell, 6),
            "cold_build_s": round(cold_build, 6),
            "cells": int(cells),
            "warm": bool(warm),
        }

    def verdict(
        self,
        cells: int,
        deadline_s: Optional[float],
        backlog_s: float = 0.0,
        warm: bool = False,
    ) -> Tuple[str, Optional[Dict[str, Any]]]:
        """Admission verdict for one request: ``("ok", None)`` when no
        deadline was requested, ``("no_estimate", None)`` when there is
        no history (admit — advisory estimator), ``("estimated", est)``
        when the deadline is feasible, ``("infeasible", est)`` when
        backlog + estimate exceed it (reject before spooling)."""
        if deadline_s is None:
            return "ok", None
        est = self.estimate(cells, warm=warm)
        if est is None:
            return "no_estimate", None
        est = dict(est)
        est["backlog_s"] = round(max(0.0, float(backlog_s)), 6)
        est["eta_s"] = round(est["backlog_s"] + est["est_s"], 6)
        est["deadline_s"] = float(deadline_s)
        if est["eta_s"] > float(deadline_s):
            return "infeasible", est
        return "estimated", est
