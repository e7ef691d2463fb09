"""Anomaly alerts: a small rule engine over the run's own records.

Counterpart: ``blades_tpu/telemetry/alerts.py`` (``AlertEngine`` :80, the
eight rules, ``install`` :292, ``evaluate_records``, ``ALERT_FILE_ENV``,
``ALERTS_ENV``), copied. The engine watches the records the run already
writes (``round``, ``metrics``, ``audit``, ``heartbeat_margin``) as they
enter the recorder's buffer (``Recorder.observer``), and writes ``alert``
records into the same buffer, so they ride the round's one flush:

| rule | severity | trigger |
|------|----------|---------|
| ``loss_nonfinite`` | critical | a round's ``train_loss`` is NaN or Inf |
| ``loss_divergence`` | critical | the last ``loss_window`` rounds' mean loss > ``loss_factor`` x the window's before |
| ``norm_collapse`` | warn | more than ``hist_top_frac`` of the update-norm histogram in its top bin |
| ``audit_breach_storm`` | warn | breach rate over the last ``breach_window`` audited rounds >= ``breach_rate`` |
| ``compile_storm`` | warn | a second round with new builds after ``compile_warmup_rounds`` rounds |
| ``heartbeat_margin_low`` | warn | a beat used most of the supervisor's timeout (``heartbeat_margin``) |
| ``heartbeat_margin_shrinking`` | warn | ``margin_trend`` shrinking margins ending below half the first |
| ``throughput_drop`` | warn | a round's wall > ``wall_factor`` x the run's median |

A rule fires at most once a run. ``compile_storm`` reads the port's
builds where the JAX rule reads XLA compiles: the round record's counter
deltas of CUDA-graph captures and ``nvcc`` kernel builds
(``cuda.graph_captures``, ``cuda.kernel_builds``; ``telemetry/
recorder.py:count_process``). A critical alert also writes itself to the
file in :data:`ALERT_FILE_ENV` when that is set (a supervisor's hook).
``BLADES_ALERTS=0`` turns the engine off, and so does
``BLADES_TELEMETRY=0``. :func:`evaluate_records` replays the rules over a
parsed trace. Stdlib only.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional

#: the build counters ``compile_storm`` sums from a round record's deltas
BUILD_COUNTERS = ("cuda.graph_captures", "cuda.kernel_builds")

#: Env var the supervisor exports (``--kill-on-alert``) pointing at the
#: file a critical alert touches; unset means no supervisor hook.
ALERT_FILE_ENV = "BLADES_ALERT_FILE"

#: Env knob disabling the engine (telemetry off disables it implicitly).
ALERTS_ENV = "BLADES_ALERTS"

DEFAULT_THRESHOLDS: Dict[str, float] = {
    # loss divergence: mean of the last `loss_window` rounds vs the mean
    # of the `loss_window` before it
    "loss_window": 3,
    "loss_factor": 1.5,
    # norm histogram: share of total mass in the top (largest-norm) bin
    "hist_top_frac": 0.5,
    # audit breaches: rate over a trailing window of audited rounds
    "breach_window": 4,
    "breach_rate": 0.5,
    # compiles after this many observed round records are a storm signal
    "compile_warmup_rounds": 2,
    # consecutive strictly-shrinking heartbeat margins
    "margin_trend": 3,
    # round wall vs the run's own median
    "wall_factor": 3.0,
    "wall_min_rounds": 5,
}


def alerts_enabled() -> bool:
    return os.environ.get(ALERTS_ENV, "1") != "0"


class AlertEngine:
    """Streaming rule evaluation over one run's record stream.

    Attach with :func:`install` (sets ``recorder.observer``); every rule
    is O(1) pure-python per record — no clock reads, no I/O (the critical
    alert-file touch is the single exception, and it fires at most once).
    """

    WATCHED = ("round", "metrics", "audit", "heartbeat_margin")

    def __init__(
        self,
        recorder=None,
        thresholds: Optional[Dict[str, float]] = None,
    ):
        self.recorder = recorder
        self.cfg = dict(DEFAULT_THRESHOLDS)
        if thresholds:
            self.cfg.update(thresholds)
        self.alerts: List[Dict[str, Any]] = []
        self._fired: set = set()
        self._losses: List[float] = []
        self._walls: List[float] = []
        self._margins: List[float] = []
        self._breaches: List[int] = []
        self._rounds_seen = 0
        self._compile_rounds = 0  # post-warmup rounds with new compiles

    # -- emission --------------------------------------------------------------

    def _alert(
        self,
        rule: str,
        severity: str,
        message: str,
        **fields: Any,
    ) -> None:
        if rule in self._fired:
            return
        self._fired.add(rule)
        rec: Dict[str, Any] = {
            "rule": rule,
            "severity": severity,
            "message": message,
            **fields,
        }
        self.alerts.append(dict(rec, t="alert"))
        if self.recorder is not None:
            self.recorder.event("alert", **rec)
            # supervisor hook is live-run only: offline replay
            # (evaluate_records) must never signal a running supervisor
            if severity == "critical":
                self._touch_alert_file(dict(rec, t="alert"))

    @staticmethod
    def _touch_alert_file(rec: Dict[str, Any]) -> None:
        """The supervisor hook: write the alert into the exported alert
        file so the watchdog can recycle the run through the degrade
        ladder. Never raises — alerting must not take down the run."""
        path = os.environ.get(ALERT_FILE_ENV)
        if not path:
            return
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as fh:
                fh.write(json.dumps(rec, default=repr) + "\n")
        except (OSError, TypeError, ValueError):
            pass

    # -- observation -----------------------------------------------------------

    def observe(self, record: Dict[str, Any]) -> None:
        """Feed one record (the recorder calls this from ``_emit``);
        exceptions are swallowed by the caller, but the rules themselves
        guard their inputs too — a malformed record must not disable
        alerting for the rest of the run."""
        t = record.get("t")
        if t == "round":
            self._on_round(record)
        elif t == "metrics":
            self._on_metrics(record)
        elif t == "audit":
            self._on_audit(record)
        elif t == "heartbeat_margin":
            self._on_margin_record(record)

    def _on_round(self, rec: Dict[str, Any]) -> None:
        self._rounds_seen += 1
        rnd = rec.get("round")
        loss = rec.get("train_loss")
        if isinstance(loss, (int, float)):
            if not math.isfinite(loss):
                self._alert(
                    "loss_nonfinite", "critical",
                    f"round {rnd}: non-finite train_loss {loss}",
                    round=rnd,
                )
            else:
                self._losses.append(float(loss))
                w = int(self.cfg["loss_window"])
                if len(self._losses) >= 2 * w:
                    recent = sum(self._losses[-w:]) / w
                    earlier = sum(self._losses[-2 * w:-w]) / w
                    if earlier > 1e-12 and recent > self.cfg["loss_factor"] * earlier:
                        self._alert(
                            "loss_divergence", "critical",
                            f"round {rnd}: window mean loss {recent:.4g} > "
                            f"{self.cfg['loss_factor']}x previous window "
                            f"{earlier:.4g}",
                            round=rnd, value=recent,
                            threshold=self.cfg["loss_factor"] * earlier,
                        )
        # compile storm: counter deltas ride every round record. One
        # post-warm-up round with builds is expected (a first graph
        # capture); a second is a storm signal
        counters = rec.get("counters") or {}
        compiles = sum(counters.get(name, 0) for name in BUILD_COUNTERS
                       if isinstance(counters.get(name, 0), (int, float)))
        if compiles > 0 and self._rounds_seen > self.cfg["compile_warmup_rounds"]:
            self._compile_rounds += 1
            if self._compile_rounds >= 2:
                self._alert(
                    "compile_storm", "warn",
                    f"round {rnd}: {int(compiles)} new graph capture(s) or kernel "
                    f"build(s) in a 2nd round past the "
                    f"{int(self.cfg['compile_warmup_rounds'])}-round warm-up "
                    "(a graph key or shape that keeps changing)",
                    round=rnd, value=float(compiles),
                )
        # throughput drop vs the run's own median
        wall = rec.get("wall_s")
        if isinstance(wall, (int, float)) and math.isfinite(wall):
            if len(self._walls) >= int(self.cfg["wall_min_rounds"]):
                med = sorted(self._walls)[len(self._walls) // 2]
                if med > 0 and wall > self.cfg["wall_factor"] * med:
                    self._alert(
                        "throughput_drop", "warn",
                        f"round {rnd}: wall {wall:.3g}s > "
                        f"{self.cfg['wall_factor']}x run median {med:.3g}s",
                        round=rnd, value=float(wall),
                        threshold=self.cfg["wall_factor"] * med,
                    )
            self._walls.append(float(wall))
        # shrinking heartbeat margin trend (gauges ride round records)
        margin = (rec.get("gauges") or {}).get("heartbeat.margin_s")
        if isinstance(margin, (int, float)) and math.isfinite(margin):
            self._margins.append(float(margin))
            n = int(self.cfg["margin_trend"])
            if len(self._margins) >= n:
                tail = self._margins[-n:]
                shrinking = all(b < a for a, b in zip(tail, tail[1:]))
                if shrinking and tail[0] > 0 and tail[-1] < 0.5 * tail[0]:
                    self._alert(
                        "heartbeat_margin_shrinking", "warn",
                        f"round {rnd}: heartbeat margin shrank "
                        f"{tail[0]:.3g}s -> {tail[-1]:.3g}s over {n} rounds",
                        round=rnd, value=tail[-1],
                    )

    def _on_metrics(self, rec: Dict[str, Any]) -> None:
        hist = rec.get("norm_hist")
        if not isinstance(hist, list) or not hist:
            return
        try:
            total = float(sum(hist))
            top = float(hist[-1])
        except (TypeError, ValueError):
            return
        if total > 0 and top / total > self.cfg["hist_top_frac"]:
            self._alert(
                "norm_collapse", "warn",
                f"round {rec.get('round')}: {top / total:.0%} of update-norm "
                "mass in the top histogram bin (norm blowup)",
                round=rec.get("round"), value=top / total,
                threshold=self.cfg["hist_top_frac"],
            )

    def _on_audit(self, rec: Dict[str, Any]) -> None:
        breach = rec.get("breach")
        if not isinstance(breach, (int, float)):
            return
        self._breaches.append(1 if breach else 0)
        w = int(self.cfg["breach_window"])
        if len(self._breaches) >= w:
            rate = sum(self._breaches[-w:]) / w
            if rate >= self.cfg["breach_rate"]:
                self._alert(
                    "audit_breach_storm", "warn",
                    f"round {rec.get('round')}: certificate breach rate "
                    f"{rate:.0%} over the last {w} audited rounds",
                    round=rec.get("round"), value=rate,
                    threshold=self.cfg["breach_rate"],
                )

    def _on_margin_record(self, rec: Dict[str, Any]) -> None:
        self._alert(
            "heartbeat_margin_low", "warn",
            f"round {rec.get('round')}: beat interval "
            f"{rec.get('interval_s')}s ate most of the "
            f"{rec.get('timeout_s')}s supervisor timeout",
            **({"round": rec["round"]} if isinstance(rec.get("round"), int)
               else {}),
            value=rec.get("margin_s"),
        )


def install(recorder, thresholds: Optional[Dict[str, float]] = None):
    """Attach an :class:`AlertEngine` to ``recorder`` (as its observer);
    returns the engine, or None when telemetry or alerting is disabled."""
    if recorder is None or not getattr(recorder, "enabled", False):
        return None
    if not alerts_enabled():
        return None
    engine = AlertEngine(recorder, thresholds=thresholds)
    recorder.observer = engine.observe
    return engine


def evaluate_records(
    records: List[Dict[str, Any]],
    thresholds: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """Offline replay: run the rule set over a parsed trace; returns the
    alert records the engine would have emitted live (used by the tests
    against committed healthy traces and by post-mortems on old traces)."""
    engine = AlertEngine(recorder=None, thresholds=thresholds)
    for rec in records:
        if isinstance(rec, dict):
            engine.observe(rec)
    return engine.alerts
