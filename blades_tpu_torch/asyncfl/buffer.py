"""The FedBuff server buffer and its staleness weighting.

Counterpart: ``blades_tpu/asyncfl/buffer.py:62-188`` (``AsyncConfig``). The
buffered-asynchronous server does not wait for all K clients: arriving
updates wait in a buffer, and once at least ``buffer_m`` are in it the
server aggregates them, each weighted by its staleness ``tau`` (server
rounds since its client downloaded the model it trained from), steps and
drains the buffer.

- The buffer has one slot per client (a client has at most one update in
  flight): a ``[K, D]`` matrix and a ``[K]`` occupancy mask, in
  ``RoundState.async_state`` with the clients' download versions and
  countdowns. A fire drains the whole buffer (first-M is the trigger).
- The weights are normalised to mean 1 over the aggregated rows
  (``w_i * n / sum(w)``) and scale the rows before the registry's
  mask-aware ``aggregate_masked``, so every registered aggregator composes
  unchanged; for the mean that is FedBuff's ``sum(w_i d_i) / sum(w_i)``.
  Constant weighting is the identity, and no multiply is made
  (``weights_are_identity``).

Modes (``staleness``): ``"constant"`` (w = 1), ``"polynomial"`` (``w = 1 /
(1 + tau)^alpha``), ``"cutoff"`` (updates staler than ``cutoff`` rounds
leave the participation mask: weight 0 as exclusion).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from blades_tpu_torch.asyncfl.arrivals import ArrivalProcess

STALENESS_MODES = ("constant", "polynomial", "cutoff")


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Buffered-asynchronous round semantics for the engine.

    ``buffer_m``: the first-M threshold (the server fires on a round whose
    buffer holds at least this many updates; clamped into ``[1, K]`` by the
    engine). ``arrivals``: an :class:`ArrivalProcess` or its keyword
    arguments. ``staleness``: the weighting mode; ``alpha`` the polynomial
    exponent; ``cutoff`` the staleness bound of ``"cutoff"``.
    """

    buffer_m: int = 1
    arrivals: Union[ArrivalProcess, Dict] = ArrivalProcess()
    staleness: str = "constant"
    alpha: float = 0.5
    cutoff: Optional[int] = None

    def __post_init__(self):
        if isinstance(self.arrivals, dict):
            object.__setattr__(self, "arrivals", ArrivalProcess(**self.arrivals))
        if self.staleness not in STALENESS_MODES:
            raise ValueError(
                f"unknown staleness mode {self.staleness!r}; one of {STALENESS_MODES}"
            )
        if self.buffer_m < 1:
            raise ValueError(f"buffer_m must be >= 1, got {self.buffer_m}")
        if self.staleness == "cutoff":
            if self.cutoff is None:
                raise ValueError("staleness='cutoff' needs an integer `cutoff`")
            if int(self.cutoff) < 0:
                # a negative bound would exclude even fresh (tau=0) rows, and
                # the zero-delay static path is faithful only when they count
                raise ValueError(f"cutoff must be >= 0, got {self.cutoff}")

    def init_state(self, num_clients: int, dim: int, device="cpu") -> Dict[str, Any]:
        """The initial ``RoundState.async_state`` on ``device``: the buffer
        and its occupancy, each slot's download version, each client's
        download version and countdown, the fire count, and, when arrivals
        can lag, the ``[max_delay + 1, D]`` ring of published params. Every
        countdown starts at 0: round 0 is a warm synchronous start."""
        k, d = int(num_clients), int(dim)
        ints = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
        state: Dict[str, Any] = {
            "buf": torch.zeros(k, d, dtype=torch.float32, device=device),
            "buf_mask": torch.zeros(k, dtype=torch.bool, device=device),
            "buf_version": ints(k),
            "version": ints(k),
            "countdown": ints(k),
            "fires": ints(),
        }
        if self.arrivals.max_delay > 0:
            state["hist"] = torch.zeros(self.arrivals.history_len, d, dtype=torch.float32,
                                        device=device)
        return state

    def staleness_mask_weights(
        self, tau: torch.Tensor, mask: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(agg_mask, weights)`` of one fire: the occupancy ``mask`` after
        the cutoff rule, and float32 weights normalised to mean 1 over it
        (1 at the other rows). ``tau``: ``[K]`` int staleness (junk where
        the mask is False)."""
        mask = mask.to(torch.bool)
        ones = torch.ones(tau.shape, dtype=torch.float32, device=tau.device)
        if self.staleness == "cutoff":
            return mask & (tau <= int(self.cutoff)), ones
        if self.staleness == "constant":
            return mask, ones
        raw = torch.pow(1.0 + torch.clamp_min(tau, 0).to(torch.float32), -float(self.alpha))
        raw = torch.where(mask, raw, 0.0)
        n = mask.to(torch.float32).sum()
        denom = torch.clamp_min(raw.sum(), 1e-12)
        w = raw * (torch.clamp_min(n, 1.0) / denom)
        return mask, torch.where(mask, w, 1.0)

    @property
    def weights_are_identity(self) -> bool:
        """True when no row multiply is needed (constant and cutoff modes;
        cutoff acts through the mask)."""
        return self.staleness in ("constant", "cutoff")

    def __repr__(self) -> str:
        parts = [f"m={self.buffer_m}", repr(self.arrivals)]
        if self.staleness == "polynomial":
            parts.append(f"poly(a={self.alpha})")
        elif self.staleness == "cutoff":
            parts.append(f"cutoff({self.cutoff})")
        else:
            parts.append("constant")
        return f"AsyncConfig({', '.join(parts)})"
