"""Request handlers: what a service request's cells run.

Counterpart: ``blades_tpu/service/handlers.py``. A request ``{"kind":
..., "cells": [...]}`` becomes ``(label, payload)`` cells and a
``run_cell`` callable for the resilient executor
(:func:`blades_tpu_torch.sweeps.resilient.run_cells_resilient`):

- ``probe``: stdlib-only cells for health checks and the chaos drills,
  ``{"label", "op": "ok" | "fail" | "sleep" | "abort", ...}``: ``ok``
  echoes a deterministic result, ``fail`` raises (the poison drill),
  ``sleep`` blocks ``sleep_s`` (the hung-cell drill), ``abort`` aborts
  the process (the worker-crash drill of the worker pool). ``sleep`` and
  ``abort`` take a ``once`` sentinel path: the first execution creates it
  and misbehaves, every later one behaves. Probe cells never import
  torch.
- ``simulate``: each cell a scenario dict (``agg``, ``attack`` /
  ``num_byz``, ``fault``, ``rounds``, ``seed``, sizes) run as a
  :class:`~blades_tpu_torch.Simulator` round sequence on the seeded
  :class:`~blades_tpu_torch.datasets.Synthetic` dataset, through the
  server's shared :class:`~blades_tpu_torch.sweeps.EngineCache`: a cell
  whose static configuration matches an earlier one reuses its engine.
  The result is a deterministic function of the scenario: the loss and a
  content hash of the final parameters (``params_sha``, the port's own:
  the f32 bytes of the ``ops/pytree.py`` flattening, which need not equal
  the JAX package's ``ravel_pytree`` order; it identifies a result across
  the port's resume, resubmission and warm runs).
- ``sweep``: a sweep driver as one request, ``{"kind": "sweep", "sweep":
  "certify" | "chaos", "spec": {...}}``, run through the driver's own
  enumerate, execute and assemble steps under the server's journal,
  accounting and scheduler. The drivers are the port's own
  (``examples/certify.py``, ``examples/chaos.py``), imported, never
  ``scripts/``; both import no torch at module scope, since the
  admission estimator loads them on the listener thread.

The JAX handlers force a virtual-CPU platform before the first jax use;
the port's server is given a ``device`` instead (``ctx["device"]``:
``"cuda"`` by default, ``"cpu"`` on request). A ``simulate`` cell or a
sweep on a ``cuda`` server runs on the card or fails: without CUDA,
``core/engine.py:resolve_device`` raises.

Every kind reduces to a :class:`RequestPlan` (:func:`build_plan`). Cell
payloads stay JSON-round-trippable: the spool and the cell journal keep
them, and a resumed request runs from the spooled copy.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import re
import time
from typing import Any, Callable, Dict, List, Tuple

__all__ = [
    "REQUEST_KINDS",
    "SWEEP_DRIVERS",
    "RequestPlan",
    "build_cells",
    "build_plan",
    "estimate_cells",
    "make_runner",
    "safe_name",
]

REQUEST_KINDS = ("probe", "simulate", "sweep")

#: Sweep drivers routable as a ``sweep`` request body.
SWEEP_DRIVERS = ("certify", "chaos")

#: Request ids and cell labels become path segments (the per-request
#: journal directory, each simulate cell's log directory, which the
#: Simulator wipes): one safe charset, checked at admission and at cell
#: build, so ``../..`` or an absolute path never reaches ``os.path.join``.
_SAFE_NAME = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,119}$")


def safe_name(value: Any, what: str) -> str:
    """``value`` as a validated path-safe name, or ``ValueError``."""
    name = str(value)
    if not _SAFE_NAME.match(name):
        raise ValueError(
            f"{what} {name!r} is not a safe name (need "
            "[A-Za-z0-9][A-Za-z0-9._-]*, max 120 chars — it becomes a "
            "filesystem path segment)"
        )
    return name


_SIM_DEFAULTS = {
    "clients": 8,
    "rounds": 2,
    "local_steps": 1,
    "train_batch_size": 8,
    "train_size": 256,
    "test_size": 64,
    "client_lr": 0.2,
    "seed": 0,
}


def build_cells(request: Dict[str, Any]) -> List[Tuple[str, Dict[str, Any]]]:
    """Validate a request and return its ``(label, payload)`` cells.

    Raises ``ValueError`` on a malformed request (the server's ``error``
    reply; the request never runs, so it costs no retry budget)."""
    kind = request.get("kind")
    if kind not in REQUEST_KINDS:
        raise ValueError(
            f"unknown request kind {kind!r} (supported: {REQUEST_KINDS})"
        )
    if kind == "sweep":
        raise ValueError(
            "sweep requests carry a driver spec, not a cells list "
            "(use build_plan)"
        )
    raw = request.get("cells")
    if not isinstance(raw, list) or not raw:
        raise ValueError("request has no cells (expected a non-empty list)")
    cells: List[Tuple[str, Dict[str, Any]]] = []
    seen = set()
    for i, payload in enumerate(raw):
        if not isinstance(payload, dict):
            raise ValueError(f"cell {i} is not an object")
        label = safe_name(payload.get("label") or f"c{i:03d}", "cell label")
        if label in seen:
            raise ValueError(f"duplicate cell label {label!r}")
        seen.add(label)
        # the runner sees the payload alone: it carries the derived label,
        # so cells without one never share a log directory
        cells.append((label, {**payload, "label": label}))
    return cells


def make_runner(
    request: Dict[str, Any], ctx: Dict[str, Any]
) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """The ``run_cell`` callable of one request. ``ctx`` carries the
    server's shared state: ``cache`` (the EngineCache), ``datasets``,
    ``device``, ``out_dir``, ``request_id``."""
    if request.get("kind") == "probe":
        return _run_probe
    return lambda payload: _run_simulate(payload, ctx)


# -- sweep drivers as request bodies -------------------------------------------


def _load_driver(name: str):
    """The port's sweep driver module ``examples/<name>.py`` (torch-free at
    module scope)."""
    return importlib.import_module(f"blades_tpu_torch.examples.{name}")


def estimate_cells(request: Dict[str, Any]) -> int:
    """The cell count of a request without running anything: the admission
    estimator's input (``service/scheduler.py:CostEstimator``) and the
    admitted ``request`` record's ``cells``. A malformed request counts 0
    (it fails with its own error when it runs)."""
    try:
        kind = request.get("kind")
        if kind == "sweep":
            driver = request.get("sweep")
            spec = request.get("spec") or {}
            if driver == "chaos":
                return max(0, int(spec.get("scenarios") or 0))
            if driver == "certify":
                mod = _load_driver("certify")
                return int(mod.total_cells(mod.spec_namespace(spec)))
            return 0
        return len(build_cells(request))
    except Exception:  # noqa: BLE001 - advisory count, never an admission error
        return 0


class RequestPlan:
    """One request's execution recipe, whatever its kind.

    - ``labels``: the cell labels in reply order (journal and spool
      identity);
    - ``execute(sweep=, journal=, options=)``: runs the cells under the
      resilient executor, returns its ``(results, walls, report)``;
    - ``finalize(results, walls, report)``: optional reply fields built
      after a complete (not preempted) execution;
    - ``slim_cells``: leave the per-cell results out of the reply (the
      sweep drivers return their artifact through ``finalize``);
    - ``resilience_kw``: the request's overrides of the server's
      ``ResilienceOptions``.
    """

    def __init__(self, labels, execute, finalize=None, slim_cells=False,
                 resilience_kw=None):
        self.labels = list(labels)
        self.execute = execute
        self.finalize = finalize
        self.slim_cells = bool(slim_cells)
        self.resilience_kw = dict(resilience_kw or {})


def build_plan(request: Dict[str, Any], ctx: Dict[str, Any]) -> RequestPlan:
    """Validate a request and return its :class:`RequestPlan`; raises
    ``ValueError`` on a malformed request."""
    if request.get("kind") == "sweep":
        driver = request.get("sweep")
        if driver not in SWEEP_DRIVERS:
            raise ValueError(
                f"unknown sweep driver {driver!r} "
                f"(supported: {SWEEP_DRIVERS})"
            )
        spec = request.get("spec") or {}
        if not isinstance(spec, dict):
            raise ValueError("sweep spec must be an object")
        if driver == "certify":
            return _certify_plan(spec, ctx)
        return _chaos_plan(spec, ctx)

    cells = build_cells(request)
    run_cell = make_runner(request, ctx)

    def execute(sweep=None, journal=None, options=None):
        from blades_tpu_torch.sweeps.resilient import run_cells_resilient

        return run_cells_resilient(
            list(cells), run_cell, sweep=sweep, journal=journal,
            options=options, kind="service",
        )

    return RequestPlan([label for label, _ in cells], execute)


def _device(ctx: Dict[str, Any]):
    """The server's device, resolved (raises for ``cuda`` without CUDA)."""
    from blades_tpu_torch.core.engine import resolve_device

    return resolve_device(ctx.get("device", "cuda"))


def _certify_plan(spec: Dict[str, Any], ctx: Dict[str, Any]) -> RequestPlan:
    """The certification matrix as a request: the SweepCells enumerated
    now (their labels are the journal identity), executed under the
    server's options, the matrix assembled only from a complete run."""
    mod = _load_driver("certify")
    args = mod.spec_namespace(spec)  # ValueError on unknown/bad knobs
    device = _device(ctx)
    plans, specs = mod.enumerate_cells(args, device)

    def execute(sweep=None, journal=None, options=None):
        return mod.execute_cells(
            args, plans, specs, sweep=sweep, journal=journal,
            resilience=options,
        )

    def finalize(results, walls, report):
        matrix = mod.assemble_matrix(
            args, plans, specs, results, walls, report, device
        )
        return {"sweep": {"driver": "certify", "matrix": matrix}}

    kw: Dict[str, Any] = {}
    if "attempts" in spec:
        kw["attempts"] = args.attempts
    if "cell_deadline" in spec:
        kw["cell_deadline_s"] = args.cell_deadline
    return RequestPlan(
        [s.label for s in specs], execute, finalize=finalize,
        slim_cells=True, resilience_kw=kw,
    )


def _chaos_plan(spec: Dict[str, Any], ctx: Dict[str, Any]) -> RequestPlan:
    """Chaos scenarios 0..N-1 as a request: one cell a seed (the scenario
    with its twin and block reruns), engines from the server's cache, the
    summary from the driver's ``summarize_rows``."""
    mod = _load_driver("chaos")
    unknown = sorted(set(spec) - {"scenarios", "attempts"})
    if unknown:
        raise ValueError(f"unknown chaos spec keys: {unknown}")
    n = int(spec.get("scenarios") or 0)
    if not 1 <= n <= 1000:
        raise ValueError("chaos spec needs 1 <= scenarios <= 1000")
    device = _device(ctx)
    labels = [
        f"s{seed:03d}/{mod.make_scenario(seed)['agg']}" for seed in range(n)
    ]
    out_dir = os.path.join(
        ctx["out_dir"], "requests", str(ctx["request_id"]), "chaos"
    )
    cache = ctx.get("cache")

    def execute(sweep=None, journal=None, options=None):
        from blades_tpu_torch.sweeps.resilient import run_cells_resilient

        return run_cells_resilient(
            [(labels[seed], seed) for seed in range(n)],
            lambda seed: mod._sweep_cell(
                mod.make_scenario(seed), seed, out_dir, cache, device=device
            ),
            sweep=sweep, journal=journal, options=options, kind="chaos",
        )

    def finalize(results, walls, report):
        stats = cache.stats() if cache is not None else {}
        return {"sweep": {
            "driver": "chaos",
            "summary": mod.summarize_rows(n, results, report, stats),
        }}

    kw: Dict[str, Any] = {}
    if "attempts" in spec:
        kw["attempts"] = int(spec["attempts"])
    return RequestPlan(
        labels, execute, finalize=finalize, slim_cells=True,
        resilience_kw=kw,
    )


# -- probe ---------------------------------------------------------------------


def _run_probe(payload: Dict[str, Any]) -> Dict[str, Any]:
    op = payload.get("op", "ok")
    # ``once``: the first execution creates the sentinel and misbehaves,
    # every later attempt finds it and behaves. The result row never
    # holds once / sleep_s, so a disturbed run's reply equals an
    # undisturbed one's.
    once = payload.get("once")
    armed = bool(once) and not os.path.exists(str(once))
    if armed:
        with open(str(once), "w") as fh:
            fh.write(str(os.getpid()))
    if op == "fail":
        raise RuntimeError(
            str(payload.get("message") or "probe cell requested failure")
        )
    if op == "abort":
        # the worker-crash drill: only meaningful under the worker pool
        # (in the server's own process it kills the server)
        if once is None or armed:
            os.abort()
    elif op == "sleep":
        # the hung-cell drill: blocks until the per-cell soft deadline or
        # completion; with ``once`` only the first attempt hangs
        if once is None or armed:
            time.sleep(float(payload.get("sleep_s", 1.0)))
    elif op not in ("ok", "fail"):
        raise ValueError(f"unknown probe op {op!r}")
    return {
        "label": str(payload["label"]),
        "op": op,
        "value": payload.get("value"),
    }


# -- simulate ------------------------------------------------------------------


def _dataset_for(scn: Dict[str, Any], ctx: Dict[str, Any]):
    """The seeded Synthetic dataset of one scenario, kept in the server's
    ``datasets`` dict under the JAX package's key (sampling is keyed off
    the Simulator's seed, so reuse changes no result)."""
    from blades_tpu_torch.datasets import Synthetic

    key = (
        int(scn["clients"]), int(scn["train_size"]),
        int(scn["test_size"]), float(scn.get("noise", 0.3)),
    )
    cache = ctx.setdefault("datasets", {})
    ds = cache.get(key)
    if ds is None:
        ds = Synthetic(
            num_clients=key[0], train_size=key[1], test_size=key[2],
            noise=key[3], cache=False,
        )
        cache[key] = ds
    return ds


def _run_simulate(
    payload: Dict[str, Any], ctx: Dict[str, Any]
) -> Dict[str, Any]:
    """One scenario cell: build (or take from the cache) the engine, run
    the rounds, return a deterministic result row."""
    import numpy as np
    import torch

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.ops.pytree import ravel

    scn = {**_SIM_DEFAULTS, **payload}
    log = os.path.join(
        ctx["out_dir"], "requests", str(ctx["request_id"]),
        str(payload["label"]),
    )
    sim = Simulator(
        dataset=_dataset_for(scn, ctx),
        aggregator=scn.get("agg", "mean"),
        aggregator_kws=dict(scn.get("agg_kws") or {}),
        attack=scn.get("attack"),
        num_byzantine=int(scn.get("num_byz", 0)),
        log_path=log,
        seed=int(scn["seed"]),
        device=_device(ctx),
    )
    sim.run(
        scn.get("model", "mlp"),
        engine_cache=ctx.get("cache"),
        global_rounds=int(scn["rounds"]),
        local_steps=int(scn["local_steps"]),
        train_batch_size=int(scn["train_batch_size"]),
        client_lr=float(scn["client_lr"]),
        server_lr=float(scn.get("server_lr", 1.0)),
        validate_interval=int(scn["rounds"]),
        fault_model=(
            dict(scn["fault"]) if scn.get("fault") else None
        ),
    )
    flat = ravel(sim.server.state.params, sim.engine.layout)
    params = flat.detach().to(torch.float32).cpu().numpy()
    ev = sim.evaluate(int(scn["rounds"]), 64)
    return {
        "label": str(payload["label"]),
        "agg": scn.get("agg", "mean"),
        "loss": round(float(ev["Loss"]), 6),
        "finite": bool(np.isfinite(params).all()),
        # a content hash, not the vector: the reply stays small and a
        # resumed request's content identity stays checkable
        "params_sha": hashlib.sha256(params.tobytes()).hexdigest()[:16],
    }
