"""The contract battery for robust aggregators.

Counterpart: ``blades_tpu/audit/contracts.py``: ``CONTRACTS``,
``DEFAULT_C``, ``nominal_f``, ``battery_kwargs``, ``battery_ctx``,
``check_permutation``, ``check_translation``, ``resilience_from_cell``,
``check_resilience``, ``battery_search_inputs`` and ``run_battery``
(:58-262), with the same tolerances (``_RTOL = 1e-3``, ``_ATOL = 1e-4``).

Three properties of a defense, checked on a ``[K, D]`` matrix:

- ``permutation``: client order does not matter, ``agg(P u) == agg(u)``
  (``[K]``-shaped context, such as FLTrust's ``trusted_mask``, permuted
  along);
- ``translation``: ``agg(u + t) == agg(u) + t``; origin-anchored defenses
  (cosine trust, norm filters, clipping around zero) fail it by design and
  say so in ``Aggregator.audit_optouts``;
- ``resilience``: the empirical (f, c) bound under the adaptive attack
  search (``audit/attack_search.py``).

The context gives ``generator`` where the JAX package gives ``key``: a CPU
``torch.Generator``, so DnC draws the same subspaces on every device.
Every defense call of a check gets a generator at that generator's state
(``attack_search._call_ctx``), as both JAX calls of ``check_permutation``
get one key: DnC then draws the same subspaces for ``u`` and for ``P u``.
The battery's random inputs (the honest trials, the permutation, the
translation, the context generator) come from :func:`battery_draws`, one
function of the seed.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.audit.attack_search import (
    QUICK_GRIDS,
    _call_ctx,
    search_cell,
    synthetic_honest,
)
from blades_tpu_torch.utils import rng

CONTRACTS = ("permutation", "translation", "resilience")

#: the default resilience constant: a point inside the Min-Max envelope is
#: within 2 rho of an honest update, itself within rho of the honest mean
DEFAULT_C = 3.0

_RTOL = 1e-3
_ATOL = 1e-4


def nominal_f(name: str, k: int) -> int:
    """The largest byzantine count the named defense nominally tolerates at
    population ``k``: 0 for the means (breakdown point 0), ``(k - 3) // 2``
    for Krum and Multi-Krum (``k >= 2f + 3``), else an honest majority,
    ``(k - 1) // 2``."""
    if name in ("mean", "asyncmean"):
        return 0
    if name in ("krum", "multikrum"):
        return max((k - 3) // 2, 0)
    return max((k - 1) // 2, 0)


def battery_kwargs(name: str, k: int, f: int) -> Dict[str, Any]:
    """Constructor kwargs of cell (name, f) at population ``k``: the cell's
    ``f`` where a defense takes a byzantine budget, Multi-Krum's selection
    at ``k - 2f - 2``, clipping radii at twice the honest deviation scale
    of :func:`synthetic_honest`, ByzantineSGD's calibrated thresholds."""
    if name in ("krum", "trimmedmean", "dnc"):
        return {"num_byzantine": f}
    if name == "multikrum":
        return {"num_byzantine": f, "num_selected": max(k - 2 * f - 2, 1)}
    if name in ("centeredclipping", "asynccenteredclipping"):
        return {"tau": 2.0}
    if name == "byzantinesgd":
        return {"th_A": 10.0, "th_B": 2.0, "th_V": 1.0}
    return {}


def battery_ctx(agg: Optional[Aggregator], k: int, d: int,
                generator: Optional[torch.Generator] = None, device="cpu") -> Dict[str, Any]:
    """The context the battery gives a defense, as the engine gives it each
    round: the last client trusted (honest; byzantine ids are the prefix),
    a zero parameter vector and a CPU generator (seed 7 by default)."""
    trusted = torch.zeros(k, dtype=torch.bool, device=device)
    trusted[k - 1] = True
    return {
        "trusted_mask": trusted,
        "params_flat": torch.zeros(d, dtype=torch.float32, device=device),
        "generator": generator if generator is not None else torch.Generator().manual_seed(7),
    }


def battery_draws(seed: int, trials: int, k: int, d: int) -> Dict[str, Any]:
    """The battery's random inputs at ``seed``, drawn on the CPU: the
    ``[T, K, D]`` honest trials, the permutation ``[K]``, the translation
    ``[D]`` (norm about 3) and the context's generator."""
    g = torch.Generator().manual_seed(int(seed))
    out = {"trials": synthetic_honest(g, trials, k, d)}
    out["perm"] = torch.randperm(k, generator=g)
    out["shift"] = 3.0 * torch.randn(d, generator=g) / np.sqrt(d)
    out["generator"] = rng.generator(int(seed), 0, rng.AGG)
    return out


def _residual_ok(a, b, scale: float = 0.0):
    res = float(torch.sqrt(torch.clamp_min(((a - b) ** 2).sum(), 0.0)))
    ref = float(torch.sqrt(torch.clamp_min((a * a).sum(), 0.0))) + float(scale)
    return res, res <= _ATOL + _RTOL * ref


def _permute_ctx(ctx: dict, perm: torch.Tensor, k: int) -> dict:
    out = {}
    for name, v in ctx.items():
        if (isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] == k
                and name != "params_flat"):
            out[name] = v[perm.to(v.device)]
        else:
            out[name] = v
    return out


def check_permutation(agg: Aggregator, updates, ctx=None, generator=None,
                      perm: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """``agg(P u) == agg(u)`` within tolerance for the permutation ``perm``
    (default: drawn from ``generator``, seed 11 without one)."""
    k, d = updates.shape
    ctx = dict(ctx or {})
    if perm is None:
        perm = torch.randperm(k, generator=generator or torch.Generator().manual_seed(11))
    perm = perm.to(updates.device)
    a, _ = agg.aggregate(updates, agg.init_state(k, d), **_call_ctx(ctx))
    b, _ = agg.aggregate(updates[perm], agg.init_state(k, d),
                         **_permute_ctx(_call_ctx(ctx), perm, k))
    res, ok = _residual_ok(a, b)
    return {"contract": "permutation", "residual": res, "ok": bool(ok)}


def check_translation(agg: Aggregator, updates, ctx=None, generator=None,
                      shift: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """``agg(u + t) == agg(u) + t`` within tolerance for the translation
    ``shift`` (default: drawn from ``generator``, seed 13 without one)."""
    k, d = updates.shape
    ctx = dict(ctx or {})
    if shift is None:
        g = generator or torch.Generator().manual_seed(13)
        shift = 3.0 * torch.randn(d, generator=g) / np.sqrt(d)
    t = shift.to(updates.device, updates.dtype)
    a, _ = agg.aggregate(updates, agg.init_state(k, d), **_call_ctx(ctx))
    b, _ = agg.aggregate(updates + t[None, :], agg.init_state(k, d), **_call_ctx(ctx))
    res, ok = _residual_ok(a + t, b, scale=float(torch.linalg.vector_norm(t)))
    return {"contract": "translation", "residual": res, "ok": bool(ok)}


def resilience_from_cell(cell: Dict[str, Any], f: int, c: float = DEFAULT_C) -> Dict[str, Any]:
    """The resilience result from a finished ``search_cell`` result (shared
    by the battery and a grouped sweep that ran the battery's cell)."""
    return {
        "contract": "resilience",
        "f": int(f),
        "c": float(c),
        "worst_ratio": cell["worst_ratio"],
        "worst_dev": cell["worst_dev"],
        "rho": cell["rho"],
        "templates": cell["templates"],
        "ok": bool(cell["worst_ratio"] <= c),
    }


def check_resilience(agg: Aggregator, trials_updates, f: int, *, ctx=None,
                     c: float = DEFAULT_C, grids: Optional[dict] = None) -> Dict[str, Any]:
    """Empirical (f, c)-resilience: the worst deviation the search finds
    stays within ``c`` times the honest spread."""
    cell = search_cell(agg, trials_updates, f, ctx=ctx, grids=grids)
    return resilience_from_cell(cell, f, c)


def battery_search_inputs(agg: Aggregator, k: int, d: int, *, trials: int = 1, seed: int = 0,
                          name: Optional[str] = None, f: Optional[int] = None, device="cpu"):
    """``(trials_updates, f, ctx)`` of the battery's resilience search, from
    :func:`battery_draws` (shared by :func:`run_battery` and the certify
    script, ``examples/certify.py``, which runs this cell in its defense's
    group)."""
    name = name or type(agg).__name__.lower()
    if f is None:
        f = max(1, nominal_f(name, k))
    draws = battery_draws(seed, trials, k, d)
    ctx = battery_ctx(agg, k, d, generator=draws["generator"], device=device)
    return draws["trials"].to(device), f, ctx


def run_battery(agg: Aggregator, *, k: int = 8, d: int = 16, f: Optional[int] = None,
                name: Optional[str] = None, c: float = DEFAULT_C, trials: int = 1,
                seed: int = 0, grids: Optional[dict] = None,
                resilience: Optional[Dict[str, Any]] = None,
                device="cpu") -> Dict[str, Dict[str, Any]]:
    """All three contracts on one defense: ``{contract: result}``, each with
    ``ok`` and the measured residual or ratio. ``f`` defaults to
    ``max(1, nominal_f)``, so the resilience check is never vacuous.
    ``resilience``: a finished resilience result (from
    :func:`resilience_from_cell`) to use instead of searching again."""
    name = name or type(agg).__name__.lower()
    if f is None:
        f = max(1, nominal_f(name, k))
    draws = battery_draws(seed, trials, k, d)
    trials_updates = draws["trials"].to(device)
    ctx = battery_ctx(agg, k, d, generator=draws["generator"], device=device)
    u0 = trials_updates[0]
    return {
        "permutation": check_permutation(agg, u0, ctx, perm=draws["perm"]),
        "translation": check_translation(agg, u0, ctx, shift=draws["shift"]),
        "resilience": resilience if resilience is not None else check_resilience(
            agg, trials_updates, f, ctx=ctx, c=c,
            grids=grids if grids is not None else QUICK_GRIDS),
    }


__all__ = [
    "CONTRACTS", "DEFAULT_C", "battery_ctx", "battery_draws", "battery_kwargs",
    "battery_search_inputs", "check_permutation", "check_resilience", "check_translation",
    "nominal_f", "resilience_from_cell", "run_battery",
]
