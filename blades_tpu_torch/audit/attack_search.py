"""Adaptive attack search: the worst deviation a defense lets through, per
(defense, f).

Counterpart: ``blades_tpu/audit/attack_search.py``: the grids
(``TEMPLATE_NAMES``, ``DEFAULT_GRIDS``, ``QUICK_GRIDS`` :55-76), the
templates ``ipm_rows``, ``alie_rows``, ``signflip_rows`` (:80-96),
``dev_directions`` (:102), ``_envelope_stats`` (:110), ``_bisect_gamma``
(:119), ``minmax_rows`` and ``minsum_rows`` (:136-168),
``honest_reference`` (:171), the per-trial body (:181-240),
``_cell_result``, ``search_cells`` and ``search_cell`` (:243-452),
``staleness_row_weights`` and ``search_cell_staleness`` (:455-537) and
``synthetic_honest`` (:540-552).

Fixed attacks understate how badly a defense breaks (Shejwalkar and
Houmansadr, NDSS 2021): the adversary searches the attack's parameter for
the worst feasible corruption. Each template rewrites the byzantine rows
(the first ``f``) of a ``[K, D]`` matrix from one scalar or direction:
IPM (``-eps * mu_h``), ALIE (``mu_h - z * std_h``), a scaled sign flip
(``-s * u_i``), and Min-Max / Min-Sum (``mu_h + gamma * dev``, gamma the
largest feasible scale inside the honest pairwise-distance envelope,
found by bisection, over three directions). The figure of merit is the
empirical (f, c)-resilience of Karimireddy et al. (2021):
``||agg(attacked) - mean(honest)|| <= c * max_i ||u_i - mean(honest)||``.

The JAX package evaluates a cell as one program: ``lax.map`` over the grid
and over the cells' ``C x T`` items, ``lax.fori_loop`` for the bisection.
Here the items and the grid points are Python loops in the same order, and
each defense runs eagerly from a fresh ``init_state``. The bisection is a
loop of fixed count whose feasibility test stays on the device
(``torch.where`` on the bracket): the search reads nothing back until a
group's ``[C*T, 5]`` deviations are done, one copy a call of
:func:`search_cells`. A defense that draws (DnC) gets a generator at the
state of the cell's ``generator`` on every call, as every JAX call gets the
cell's one key. An item's result depends only on its own inputs, so
:func:`search_cells` over C cells equals C calls of :func:`search_cell`
bit for bit.

On a CUDA matrix trimmed mean with ``1 <= b <= 16`` and ``2b < K`` runs the
Hopper kernel (``ops/trimmed.py``) wherever a cell has no participation
mask; a staleness cell whose mask excludes rows takes the masked form, as
in the JAX package.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.asyncfl import AsyncConfig
from blades_tpu_torch.attackers.base import honest_stats
from blades_tpu_torch.ops.distances import pairwise_sq_euclidean
from blades_tpu_torch.telemetry import recorder as _trecorder
from blades_tpu_torch.telemetry import timeline as _timeline
from blades_tpu_torch.utils import rng

TEMPLATE_NAMES = ("ipm", "alie", "signflip", "minmax", "minsum")

#: the full search's grids (``examples/certify.py``)
DEFAULT_GRIDS: Dict[str, Any] = {
    "ipm_eps": np.logspace(-1.0, 3.0, 9),
    "alie_z": np.linspace(0.25, 4.0, 8),
    "signflip_s": np.logspace(-1.0, 3.0, 9),
    "n_bisect": 20,
    "gamma_init": 10.0,
}

#: reduced grids (``examples/certify.py --quick``, the contract battery)
QUICK_GRIDS: Dict[str, Any] = {
    "ipm_eps": np.asarray([1.0, 100.0]),
    "alie_z": np.asarray([1.5, 3.0]),
    "signflip_s": np.asarray([1.0, 100.0]),
    "n_bisect": 12,
    "gamma_init": 10.0,
}


# -- attack templates ---------------------------------------------------------


def ipm_rows(updates, byz_mask, eps, part_mask=None):
    """Byzantine rows become ``-eps * mean(honest)``."""
    mu, _, _ = honest_stats(updates, byz_mask, part_mask)
    return torch.where(byz_mask[:, None], -eps * mu[None, :], updates)


def alie_rows(updates, byz_mask, z, part_mask=None):
    """Byzantine rows become ``mu - z * std`` over the honest rows."""
    mu, std, _ = honest_stats(updates, byz_mask, part_mask)
    return torch.where(byz_mask[:, None], (mu - z * std)[None, :], updates)


def signflip_rows(updates, byz_mask, s, part_mask=None):
    """Byzantine rows flip and scale their own update: ``-s * u_i``."""
    return torch.where(byz_mask[:, None], -s * updates, updates)


def _unit(v, eps=1e-12):
    return v / torch.clamp_min(torch.sqrt((v * v).sum()), eps)


def dev_directions(updates, byz_mask, part_mask=None):
    """The ``[3, D]`` Min-Max / Min-Sum directions: the negative unit
    honest std, honest mean and sign of the honest mean."""
    mu, std, _ = honest_stats(updates, byz_mask, part_mask)
    return torch.stack([-_unit(std), -_unit(mu), -_unit(torch.sign(mu))])


def _honest_rows(byz_mask, part_mask):
    return ~byz_mask if part_mask is None else (~byz_mask & part_mask)


def _envelope_stats(updates, byz_mask, part_mask):
    """Honest row weights and the honest-masked ``[K, K]`` squared
    distances: the envelope Min-Max and Min-Sum bisect against."""
    honest_w = _honest_rows(byz_mask, part_mask).to(updates.dtype)
    sq = pairwise_sq_euclidean(updates) * (honest_w[:, None] * honest_w[None, :])
    return honest_w, sq


def _bisect_gamma(feasible, gamma_init, n_bisect, like):
    """The largest feasible attack scale by ``n_bisect`` bisection steps, a
    loop of fixed count with the test on the device (JAX
    ``lax.fori_loop``); never below 0 (a one-row honest envelope drives it
    to about 0)."""
    gamma = torch.full((), float(gamma_init), dtype=like.dtype, device=like.device)
    step = gamma / 2.0
    for _ in range(int(n_bisect)):
        gamma = torch.where(feasible(gamma), gamma + step, gamma - step)
        step = step / 2.0
    return torch.clamp_min(gamma, 0.0)


def minmax_rows(updates, byz_mask, dev, part_mask=None, n_bisect=20, gamma_init=10.0):
    """Min-Max: the largest gamma whose point ``mu + gamma * dev`` is no
    farther from any honest update than the largest honest pair."""
    mu, _, _ = honest_stats(updates, byz_mask, part_mask)
    honest_w, sq = _envelope_stats(updates, byz_mask, part_mask)
    bound = sq.max()

    def feasible(gamma):
        mal = mu + gamma * dev
        d = ((updates - mal[None, :]) ** 2).sum(dim=1) * honest_w
        return d.max() <= bound

    gamma = _bisect_gamma(feasible, gamma_init, n_bisect, updates)
    return torch.where(byz_mask[:, None], (mu + gamma * dev)[None, :], updates)


def minsum_rows(updates, byz_mask, dev, part_mask=None, n_bisect=20, gamma_init=10.0):
    """Min-Sum: the largest gamma whose point's summed squared distance to
    the honest rows is within the worst honest row's."""
    mu, _, _ = honest_stats(updates, byz_mask, part_mask)
    honest_w, sq = _envelope_stats(updates, byz_mask, part_mask)
    bound = sq.sum(dim=1).max()

    def feasible(gamma):
        mal = mu + gamma * dev
        d = (((updates - mal[None, :]) ** 2).sum(dim=1) * honest_w).sum()
        return d <= bound

    gamma = _bisect_gamma(feasible, gamma_init, n_bisect, updates)
    return torch.where(byz_mask[:, None], (mu + gamma * dev)[None, :], updates)


# -- the per-cell search ------------------------------------------------------


def honest_reference(updates, byz_mask, part_mask=None):
    """``(mu_h, rho)``: the honest mean and the largest honest deviation
    from it, the two sides of the resilience bound."""
    mu, _, _ = honest_stats(updates, byz_mask, part_mask)
    dev = torch.sqrt(torch.clamp_min(((updates - mu) ** 2).sum(dim=1), 0.0))
    rho = torch.where(_honest_rows(byz_mask, part_mask), dev, 0.0).max()
    return mu, rho


def _call_ctx(ctx: dict) -> dict:
    """The context of one defense call: a generator at the state of the
    cell's, so every call draws what the first would."""
    out = dict(ctx)
    if "generator" in out:
        out["generator"] = rng.clone(out["generator"])
    return out


def _grid_params(grids: dict, like: torch.Tensor) -> dict:
    """The scalar templates' grids as tensors on ``like``'s device, made once
    a call of :func:`search_cells` (one host-to-device copy each)."""
    return {name: torch.as_tensor(np.asarray(grids[name]), dtype=like.dtype).to(like.device)
            for name in ("ipm_eps", "alie_z", "signflip_s")}


def _trial(agg: Aggregator, u, byz_mask, part_mask, ctx: dict, grids: dict, params: dict):
    """One item of the search (JAX ``_trial_body`` :181-240): the worst
    deviation of each template over its grid, ``[5]``, and ``rho``, both on
    the device; ``params`` holds the grids on the device."""
    k, d = u.shape
    n_bisect = int(grids["n_bisect"])
    gamma_init = float(grids["gamma_init"])
    mu_h, rho = honest_reference(u, byz_mask, part_mask)

    def deviation(attacked):
        out, _ = agg.aggregate_masked(attacked, agg.init_state(k, d), mask=part_mask,
                                      **_call_ctx(ctx))
        return torch.sqrt(torch.clamp_min(((out - mu_h) ** 2).sum(), 0.0))

    def sweep(template, grid):
        return torch.stack([deviation(template(u, byz_mask, p, part_mask))
                            for p in grid]).max()

    def sweep_env(template):
        devs = dev_directions(u, byz_mask, part_mask)
        return torch.stack([
            deviation(template(u, byz_mask, dv, part_mask, n_bisect=n_bisect,
                               gamma_init=gamma_init))
            for dv in devs]).max()

    per_template = torch.stack([
        sweep(ipm_rows, params["ipm_eps"]),
        sweep(alie_rows, params["alie_z"]),
        sweep(signflip_rows, params["signflip_s"]),
        sweep_env(minmax_rows),
        sweep_env(minsum_rows),
    ])
    return per_template, rho


def _cell_result(devs: np.ndarray, rhos: np.ndarray) -> Dict[str, Any]:
    """:func:`search_cell`'s result from one cell's ``[T, 5]`` deviations
    and ``[T]`` honest spreads."""
    devs = np.asarray(devs, dtype=np.float64)
    rhos = np.maximum(np.asarray(rhos, dtype=np.float64), 1e-9)
    ratios = devs / rhos[:, None]
    templates = {
        name: {"worst_dev": float(devs[:, i].max()), "worst_ratio": float(ratios[:, i].max())}
        for i, name in enumerate(TEMPLATE_NAMES)
    }
    return {
        "templates": templates,
        "worst_dev": float(devs.max()),
        "worst_ratio": float(ratios.max()),
        "rho": float(rhos.mean()),
    }


def search_cells(agg: Aggregator, cells, *, grids: Optional[dict] = None,
                 batch_label: Optional[str] = None) -> list:
    """The worst-case search for many cells of one program shape.

    ``cells``: dicts ``{"trials": [T, K, D], "f": int, "ctx": dict,
    "part_mask": None | [K], "label": str}`` sharing the trial shape, the
    context's keys and the presence of a participation mask
    (``sweeps.plan_groups`` groups them; this checks it). Each of the
    ``C x T`` items is searched in input order from a fresh
    ``agg.init_state``; the deviations come to the host once, at the end.
    Returns one :func:`search_cell` result per cell, in input order, and
    writes ``sweep`` records onto the active recorder
    (``telemetry/timeline.py``)."""
    cells = list(cells)
    if not cells:
        return []
    t0 = time.perf_counter()
    counters0 = _trecorder.process_counters()
    g = dict(DEFAULT_GRIDS)
    g.update(grids or {})

    trials = [c["trials"][None] if c["trials"].dim() == 2 else c["trials"] for c in cells]
    t, k, d = trials[0].shape
    for tr in trials[1:]:
        if tuple(tr.shape) != (t, k, d):
            raise ValueError(f"cells in one batch must share the trial shape: "
                             f"{tuple(tr.shape)} != {(t, k, d)}")
    has_part = [c.get("part_mask") is not None for c in cells]
    if any(has_part) != all(has_part):
        raise ValueError("cells in one batch must have uniform part-mask presence")
    ctx_keys = tuple(sorted(cells[0].get("ctx") or {}))
    for c in cells[1:]:
        if tuple(sorted(c.get("ctx") or {})) != ctx_keys:
            raise ValueError("cells in one batch must share the aggregation-context structure")

    devs, rhos = [], []
    params = _grid_params(g, trials[0])
    for cell, tr in zip(cells, trials):
        dev = tr.device
        byz = torch.arange(k, device=dev) < int(cell["f"])
        part = cell.get("part_mask")
        if part is not None:
            part = torch.as_tensor(part).to(dev, torch.bool)
        ctx = {name: (v.to(dev) if isinstance(v, torch.Tensor) else v)
               for name, v in (cell.get("ctx") or {}).items()}
        for i in range(t):
            per_template, rho = _trial(agg, tr[i], byz, part, ctx, g, params)
            devs.append(per_template)
            rhos.append(rho)
    n = len(cells)
    devs = torch.stack(devs).cpu().numpy().astype(np.float64).reshape(n, t, len(TEMPLATE_NAMES))
    rhos = torch.stack(rhos).cpu().numpy().astype(np.float64).reshape(n, t)
    results = [_cell_result(devs[i], rhos[i]) for i in range(n)]

    wall = time.perf_counter() - t0
    labels = [c.get("label") or f"f{c['f']}/k{k}" for c in cells]
    if n == 1:
        _timeline.sweep_cell_event("attack_search", labels[0], wall, counters0)
    else:
        _timeline.sweep_batch_events("attack_search", labels, wall, counters0,
                                     batch=batch_label or f"batch{n}/k{k}")
    return results


def search_cell(agg: Aggregator, trials_updates: torch.Tensor, f: int, *,
                ctx: Optional[dict] = None, grids: Optional[dict] = None,
                part_mask: Optional[torch.Tensor] = None,
                cell_label: Optional[str] = None) -> Dict[str, Any]:
    """The worst-case search for one (defense, f) cell: ``trials_updates``
    ``[T, K, D]`` (or ``[K, D]``) honest draws, the first ``f`` rows
    byzantine, the defense from a fresh ``init_state`` (a stateful defense
    certifies its first round). The one-cell form of :func:`search_cells`.

    Returns ``{"templates": {name: {"worst_dev", "worst_ratio"}},
    "worst_dev", "worst_ratio", "rho"}``: the ratio is the deviation over
    the trial's largest honest deviation ``rho`` (floored at 1e-9)."""
    k = trials_updates.shape[-2]
    return search_cells(
        agg,
        [{"trials": trials_updates, "f": int(f), "ctx": dict(ctx or {}),
          "part_mask": part_mask, "label": cell_label or f"f{int(f)}/k{k}"}],
        grids=grids,
    )[0]


# -- staleness (the buffered-async threat model) --------------------------------
#
# The async server aggregates staleness-weighted rows. Byzantine clients
# choose when they report, so they choose their weight and pre-scale their
# payload to cancel it; honest stragglers are damped unevenly, which
# distorts the honest geometry every defense reasons over. The staleness
# search runs the templates on the weighted matrix the server sees.


def staleness_row_weights(k: int, f: int, *, mode: str = "polynomial", alpha: float = 0.5,
                          tau_max: int = 3, tau_byz: int = 0, cutoff: Optional[int] = None,
                          device="cpu"):
    """``(mask, weights, tau)`` of one staleness scenario: honest rows on
    the ladder ``0..tau_max`` (cycled), byzantine rows all at ``tau_byz``;
    the normalization and the cutoff rule are ``AsyncConfig``'s
    (``asyncfl/buffer.py``), as the engine applies them."""
    ar = torch.arange(k, device=device)
    byz = ar < f
    honest_tau = torch.remainder(torch.clamp_min(ar - f, 0), tau_max + 1)
    tau = torch.where(byz, torch.full_like(ar, int(tau_byz)), honest_tau).to(torch.int32)
    cfg = AsyncConfig(buffer_m=1, staleness=mode, alpha=alpha, cutoff=cutoff)
    mask, w = cfg.staleness_mask_weights(tau, torch.ones(k, dtype=torch.bool, device=device))
    return mask, w, tau


def staleness_info(mask, w, f: int, *, mode: str, alpha: float, tau_max: int, tau_byz: int,
                   cutoff: Optional[int] = None) -> Dict[str, Any]:
    """The scenario fields of a staleness cell's result."""
    return {
        "mode": mode,
        "alpha": alpha,
        "tau_max": int(tau_max),
        "tau_byz": int(tau_byz),
        **({"cutoff": int(cutoff)} if cutoff is not None else {}),
        "weight_byz": float(w[0]) if f > 0 else None,
        "weight_min": float(torch.where(mask, w, float("inf")).min()),
    }


def search_cell_staleness(agg: Aggregator, trials_updates: torch.Tensor, f: int, *,
                          mode: str = "polynomial", alpha: float = 0.5, tau_max: int = 3,
                          tau_byz: int = 0, cutoff: Optional[int] = None,
                          ctx: Optional[dict] = None, grids: Optional[dict] = None,
                          cell_label: Optional[str] = None) -> Dict[str, Any]:
    """:func:`search_cell` on the staleness-weighted matrix: each honest
    row scaled by its normalized weight, the templates rewriting the
    byzantine rows (the weight-compensating adversary), the reference taken
    over the weighted honest rows; with the scenario's fields under
    ``"staleness"``."""
    if trials_updates.dim() == 2:
        trials_updates = trials_updates[None]
    k = trials_updates.shape[1]
    mask, w, _ = staleness_row_weights(k, f, mode=mode, alpha=alpha, tau_max=tau_max,
                                       tau_byz=tau_byz, cutoff=cutoff,
                                       device=trials_updates.device)
    weighted = trials_updates * w[None, :, None]
    part = None if bool(mask.all()) else mask
    out = search_cell(agg, weighted, f, ctx=ctx, grids=grids, part_mask=part,
                      cell_label=cell_label or f"f{f}/k{k}/tau{tau_byz}")
    out["staleness"] = staleness_info(mask, w, f, mode=mode, alpha=alpha, tau_max=tau_max,
                                      tau_byz=tau_byz, cutoff=cutoff)
    return out


def synthetic_honest(generator: torch.Generator, trials: int, k: int, d: int,
                     center_scale: float = 2.0, spread: float = 1.0,
                     device="cpu") -> torch.Tensor:
    """``[T, K, D]`` float32 honest draws: a per-trial center of norm about
    ``center_scale`` plus per-row noise of norm about ``spread``, so the
    largest honest deviation ``rho`` is about ``spread``. Drawn from
    ``generator`` (centers, then noise) on its device and moved to
    ``device``, so a CPU generator gives the same draws for every device."""
    gdev = generator.device
    centers = torch.randn(trials, 1, d, generator=generator, device=gdev)
    noise = torch.randn(trials, k, d, generator=generator, device=gdev)
    centers = center_scale * centers / np.sqrt(d)
    noise = spread * noise / np.sqrt(d)
    return (centers + noise).to(torch.float32).to(device)


__all__ = [
    "DEFAULT_GRIDS", "QUICK_GRIDS", "TEMPLATE_NAMES", "alie_rows", "dev_directions",
    "honest_reference", "ipm_rows", "minmax_rows", "minsum_rows", "search_cell",
    "search_cell_staleness", "search_cells", "signflip_rows", "staleness_info",
    "staleness_row_weights", "synthetic_honest",
]
