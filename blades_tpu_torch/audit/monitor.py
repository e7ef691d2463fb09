"""Runtime robustness contracts: per-round certificates and a certified
fallback.

Counterpart: ``blades_tpu/audit/monitor.py`` (``CERTIFICATE_NAMES``,
``AuditMonitor``: ``certify`` :108, ``apply`` :157, the streaming forms
``streaming_init`` / ``streaming_update`` / ``streaming_apply`` :225-348).
Two certificates run inside the round, on the participating rows:

- ``median_ball`` — the applied aggregate stays within
  ``median_ball_factor`` times the participants' robust spread of their
  coordinate-wise median, ``||agg - med|| <= c * median_i ||u_i - med||``;
- ``envelope`` — the aggregate stays inside the participants'
  pairwise-distance envelope,
  ``max_i ||agg - u_i|| <= envelope_factor * max_ij ||u_i - u_j||``.

A breach is a per-round 0-d flag. With ``fallback_aggregator=`` set, a
round that breaches applies the fallback defense's aggregate instead; the
fallback is computed every round beside the primary and swapped in by a
``torch.where``, so the round makes no host sync and a captured round
replays it. Masked-out rows are zeroed before any certificate arithmetic.
With ``fallback_aggregator="trimmedmean"`` and no mask the fallback is the
trimmed mean's unmasked ``aggregate``: on a CUDA tensor the Hopper kernel,
a second launch in the round.

Everything runs on the port's ``ops/masked.py``, ``ops/distances.py`` and
``ops/streaming.py``; the ``[K, K]`` Gram matrix of the envelope is one
GEMM. The offline certification battery and the attack search are
``contracts.py`` and ``attack_search.py`` beside this module.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from blades_tpu_torch.ops.distances import pairwise_sq_euclidean
from blades_tpu_torch.ops.masked import masked_mean, masked_median, masked_median_1d
from blades_tpu_torch.ops.streaming import chunk_geometry, stack_init, stack_write

CERTIFICATE_NAMES = ("median_ball", "envelope")


def _norm(v):
    return torch.sqrt(torch.clamp_min((v * v).sum(), 0.0))


def _row_dists(rows, point):
    diff = rows - point[None, :]
    return torch.sqrt(torch.clamp_min((diff * diff).sum(dim=1), 0.0))


def _participation(updates, mask):
    """The ``[K]`` bool mask on the updates' device and the updates with
    masked-out rows zeroed by ``where``; without a mask, all True and the
    updates themselves (the ``where`` would copy them unchanged)."""
    if mask is None:
        return torch.ones(updates.shape[0], dtype=torch.bool, device=updates.device), updates
    m = torch.as_tensor(mask).to(updates.device, torch.bool)
    return m, torch.where(m[:, None], updates, 0.0)


@dataclasses.dataclass(frozen=True)
class AuditMonitor:
    """Round-level robustness certificates with an optional certified
    fallback.

    ``median_ball_factor``: the ``c`` of the median-ball certificate (3.0,
    the constant of the JAX package's offline certification).
    ``envelope_factor``: slack on the pairwise-distance envelope.
    ``certificates``: which certificates can trigger the fallback (both are
    always recorded). ``fallback_aggregator``: a registry name or an
    :class:`~blades_tpu_torch.aggregators.base.Aggregator`, swapped in on a
    breached round; it must be stateless (it runs from an empty state every
    round).
    """

    median_ball_factor: float = 3.0
    envelope_factor: float = 1.0
    certificates: Tuple[str, ...] = ("median_ball", "envelope")
    fallback_aggregator: Any = None

    def __post_init__(self):
        certs = tuple(self.certificates)
        for c in certs:
            if c not in CERTIFICATE_NAMES:
                raise ValueError(f"unknown certificate {c!r}; available: {CERTIFICATE_NAMES}")
        if not certs:
            raise ValueError("certificates must name at least one certificate")
        object.__setattr__(self, "certificates", certs)
        fb = self.fallback_aggregator
        if isinstance(fb, str):
            from blades_tpu_torch.aggregators import get_aggregator

            fb = get_aggregator(fb)
        if fb is not None and getattr(fb, "stateful", False):
            raise ValueError(
                f"fallback aggregator {fb!r} is stateful; the fallback runs from a fresh "
                "state each breached round — use a stateless defense "
                "(median/trimmedmean/geomed)"
            )
        object.__setattr__(self, "fallback_aggregator", fb)

    # -- the dense certificates ----------------------------------------------

    def certify(self, updates: torch.Tensor, agg: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
        """Both certificates on the participating rows against a candidate
        aggregate: ``(breach, diag)``, ``breach`` a 0-d bool (an enforced
        certificate fails on a round with at least one participant)."""
        m, safe = _participation(updates, mask)
        n = m.to(torch.int32).sum(dtype=torch.int32)

        med = masked_median(safe, m)
        r_hat = masked_median_1d(_row_dists(safe, med), m)
        dev_med = _norm(agg - med)
        slack_med = 1e-6 * (1.0 + _norm(med))
        median_ok = dev_med <= self.median_ball_factor * r_hat + slack_med

        d2 = pairwise_sq_euclidean(safe)
        pair = m[:, None] & m[None, :]
        diameter = torch.sqrt(torch.clamp_min(torch.where(pair, d2, 0.0).max(), 0.0))
        agg_reach = torch.where(m, _row_dists(safe, agg), 0.0).max()
        slack_env = 1e-6 * (1.0 + diameter)
        envelope_ok = agg_reach <= self.envelope_factor * diameter + slack_env

        breach = (n > 0) & ~self._ok(median_ok, envelope_ok)
        diag = {
            "participants": n,
            "cert_median_ball": median_ok.to(torch.int32),
            "cert_envelope": envelope_ok.to(torch.int32),
            "dev_median": dev_med,
            "spread_median": r_hat,
            "diameter": diameter,
        }
        return breach, diag

    def _ok(self, median_ok, envelope_ok):
        """The enforced certificates' verdict, a 0-d bool."""
        ok = torch.ones((), dtype=torch.bool, device=median_ok.device)
        if "median_ball" in self.certificates:
            ok = ok & median_ok
        if "envelope" in self.certificates:
            ok = ok & envelope_ok
        return ok

    def apply(self, updates: torch.Tensor, agg: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None, byz_mask: Optional[torch.Tensor] = None,
              **ctx) -> Tuple[torch.Tensor, dict]:
        """Certify ``agg``; on a breach, the fallback's aggregate (when one
        is configured). ``ctx`` is the round's aggregation context, handed
        to the fallback. ``byz_mask`` (the simulator's ground truth) adds the
        honest-reference fields: the applied aggregate's distance from the
        honest participants' mean and the largest honest distance from it,
        the two sides of the (f, c) bound."""
        breach, diag = self.certify(updates, agg, mask)
        m, safe = _participation(updates, mask)

        final = agg
        fallback_used = torch.zeros((), dtype=torch.bool, device=agg.device)
        if self.fallback_aggregator is not None:
            fb, _ = self.fallback_aggregator.aggregate_masked(updates, (), mask=mask, **ctx)
            final = torch.where(breach, fb, agg)
            fallback_used = breach

        diag["breach"] = breach.to(torch.int32)
        diag["fallback_used"] = fallback_used.to(torch.int32)
        diag["agg_norm"] = _norm(final)
        if byz_mask is not None:
            honest = m & ~byz_mask.to(m.device)
            nh = honest.to(torch.int32).sum(dtype=torch.int32)
            mu_h = masked_mean(safe, honest)
            hd = torch.where(honest, _row_dists(safe, mu_h), 0.0).max()
            has_h = nh > 0
            diag["honest_participants"] = nh
            diag["max_honest_dev"] = torch.where(has_h, hd, 0.0)
            diag["dev_honest"] = torch.where(has_h, _norm(final - mu_h), 0.0)
            diag["dev_honest_raw"] = torch.where(has_h, _norm(agg - mu_h), 0.0)
        return final, diag

    # -- the streaming certificates -------------------------------------------
    #
    # The streaming round never holds [K, D]. Per chunk the state keeps the
    # chunk's coordinate-wise median, each row's distance to it, the chunk
    # radius and the exact within-chunk diameter. At the end the median of
    # the chunk medians and the triangle inequality bound every dense row
    # statistic against a point known only then; a certificate breaches
    # only when it is sure (JAX :205-223). Singleton chunks make every
    # interval a point, and the streaming certificates equal the dense ones.

    def streaming_init(self, num_clients: int, num_chunks: int, chunk_size: int, dim: int,
                       *, device="cpu") -> dict:
        return {
            "meds": stack_init(num_chunks, (dim,), device=device),
            "counts": torch.zeros(num_chunks, dtype=torch.int32, device=device),
            "row_dist": stack_init(num_chunks, (chunk_size,), device=device),
            "row_mask": torch.zeros((num_chunks, chunk_size), dtype=torch.bool, device=device),
            "radius": torch.zeros(num_chunks, dtype=torch.float32, device=device),
            "diam": torch.zeros(num_chunks, dtype=torch.float32, device=device),
        }

    def streaming_update(self, astate: dict, slab: torch.Tensor, *, chunk_mask: torch.Tensor,
                         chunk_index: int) -> dict:
        med_c = masked_median(slab, chunk_mask)
        geo = chunk_geometry(slab, chunk_mask, med_c)
        n = chunk_mask.to(torch.int32).sum(dtype=torch.int32)
        return {
            "meds": stack_write(astate["meds"], chunk_index,
                                torch.where(n > 0, med_c, 0.0)),
            "counts": stack_write(astate["counts"], chunk_index, n),
            "row_dist": stack_write(astate["row_dist"], chunk_index, geo["row_dist"]),
            "row_mask": stack_write(astate["row_mask"], chunk_index, chunk_mask),
            "radius": stack_write(astate["radius"], chunk_index, geo["radius"]),
            "diam": stack_write(astate["diam"], chunk_index, geo["diameter"]),
        }

    def streaming_apply(self, astate: dict, agg: torch.Tensor, *,
                        fallback_agg: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
        """The streaming certificates against the finalized aggregate; on a
        sure breach, ``fallback_agg`` (the fallback's own streaming
        finalize). The diag has :meth:`apply`'s fields with bound-valued
        spread and diameter, plus the lo/hi intervals; the honest-reference
        fields need the rows and are dense only."""
        meds, counts = astate["meds"], astate["counts"]
        chunk_ok = counts > 0
        n = counts.sum(dtype=torch.int32)
        med_s = masked_median(meds, chunk_ok)

        # per-chunk centre offsets against points known only now
        e_med = torch.where(chunk_ok, _row_dists(meds, med_s), 0.0)  # ||c_j - med||
        e_agg = torch.where(chunk_ok, _row_dists(meds, agg), 0.0)  # ||c_j - agg||

        d = astate["row_dist"]  # [C, chunk] row -> own-chunk median
        rmask = astate["row_mask"].reshape(-1)
        lo = torch.clamp_min(d - e_med[:, None], 0.0)
        hi = d + e_med[:, None]
        r_hat_lo = masked_median_1d(lo.reshape(-1), rmask)
        r_hat_hi = masked_median_1d(hi.reshape(-1), rmask)

        dev_med = _norm(agg - med_s)
        slack_med = 1e-6 * (1.0 + _norm(med_s))
        median_ok = dev_med <= self.median_ball_factor * r_hat_hi + slack_med

        radius = astate["radius"]
        reach_hi = torch.where(chunk_ok, e_agg + radius, 0.0).max()
        reach_lo = torch.where(chunk_ok, torch.clamp_min(e_agg - radius, 0.0), 0.0).max()
        # cross-chunk diameter bounds from centre distances +- radii; the
        # diagonal term (2 r_j) dominates the exact in-chunk diameter
        cdist = torch.sqrt(torch.clamp_min(pairwise_sq_euclidean(meds), 0.0))
        pair_ok = chunk_ok[:, None] & chunk_ok[None, :]
        diam_hi = torch.where(pair_ok, cdist + radius[:, None] + radius[None, :], 0.0).max()
        diam_lo = torch.maximum(
            torch.where(chunk_ok, astate["diam"], 0.0).max(),
            torch.where(pair_ok, cdist - radius[:, None] - radius[None, :], 0.0).max(),
        )
        slack_env = 1e-6 * (1.0 + diam_hi)
        envelope_ok = reach_lo <= self.envelope_factor * diam_hi + slack_env

        breach = (n > 0) & ~self._ok(median_ok, envelope_ok)
        final = agg
        fallback_used = torch.zeros((), dtype=torch.bool, device=agg.device)
        if fallback_agg is not None:
            final = torch.where(breach, fallback_agg, agg)
            fallback_used = breach

        diag = {
            "participants": n,
            "cert_median_ball": median_ok.to(torch.int32),
            "cert_envelope": envelope_ok.to(torch.int32),
            "dev_median": dev_med,
            "spread_median": r_hat_hi,
            "spread_median_lo": r_hat_lo,
            "diameter": diam_hi,
            "diameter_lo": diam_lo,
            "agg_reach_lo": reach_lo,
            "agg_reach_hi": reach_hi,
            "breach": breach.to(torch.int32),
            "fallback_used": fallback_used.to(torch.int32),
            "agg_norm": _norm(final),
        }
        return final, diag

    def __repr__(self) -> str:
        parts = [f"certs={'+'.join(self.certificates)}", f"c={self.median_ball_factor}"]
        if self.fallback_aggregator is not None:
            parts.append(f"fallback={self.fallback_aggregator!r}")
        return f"AuditMonitor({', '.join(parts)})"
