"""Seeded client arrival process for the buffered-asynchronous round.

Counterpart: ``blades_tpu/asyncfl/arrivals.py:55-161`` (``ArrivalProcess``):
every client carries an integer countdown, the server rounds until its
in-flight update arrives; a client whose countdown reaches zero arrives,
re-downloads the current model and draws a fresh delay. Kinds:

- ``"zero"``: every delay is 0, clients arrive every round;
- ``"fixed"``: a static per-client delay vector;
- ``"uniform"``: i.i.d. integer delays on ``[min_delay, max_delay]``;
- ``"geometric"``: ``floor(log(u) / log1p(-p))`` with ``u ~ U[1e-7, 1)``
  and ``p = 1 / (1 + mean_delay)``, clipped to ``[0, max_delay]``
  (:func:`geometric_delays`).

A round's ``[K]`` draws come from one generator, the round's ``ARRIVAL``
stream (``utils/rng.py``), which the engine passes to
:meth:`ArrivalProcess.draw`, where the JAX package folds the client id
into its round key. Torch cannot reproduce threefry's bits, so tests hand
the port's draws to the JAX package; :func:`geometric_delays` takes ``u``
as an argument so that a test can give both packages the same ``u``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_KINDS = ("zero", "fixed", "uniform", "geometric")
#: the geometric draw's lower bound on ``u`` (``log(0)`` is ``-inf``)
U_MIN = 1e-7


def geometric_delays(u: torch.Tensor, mean_delay: float, max_delay: int) -> torch.Tensor:
    """Delays from uniforms ``u`` on ``[U_MIN, 1)``: the inverse-CDF draw of a
    geometric law of mean ``mean_delay``, in float32 as the JAX package
    computes it, clipped to ``[0, max_delay]``; int32."""
    p = 1.0 / (1.0 + float(mean_delay))
    log_q = torch.log1p(torch.full((), -p, dtype=torch.float32, device=u.device))
    g = torch.floor(torch.log(u.to(torch.float32)) / log_q).to(torch.int32)
    return torch.clamp(g, 0, int(max_delay))


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Per-client delay distribution (see the module docstring).

    ``max_delay`` bounds every draw and sizes the engine's ring of published
    params (``history_len`` rows of ``[D]``); ``min_delay`` is the uniform
    lower bound, ``mean_delay`` the geometric mean, ``delays`` the fixed
    kind's per-client vector (its maximum raises ``max_delay``)."""

    kind: str = "zero"
    max_delay: int = 0
    min_delay: int = 0
    mean_delay: float = 1.0
    delays: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown arrival kind {self.kind!r}; one of {_KINDS}")
        if self.max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {self.max_delay}")
        if self.kind == "zero" and self.max_delay != 0:
            object.__setattr__(self, "max_delay", 0)
        if self.kind == "fixed":
            if self.delays is None:
                raise ValueError("kind='fixed' needs a per-client `delays` vector")
            d = tuple(int(x) for x in self.delays)
            if any(x < 0 for x in d):
                raise ValueError("fixed delays must be >= 0")
            object.__setattr__(self, "delays", d)
            object.__setattr__(self, "max_delay", max(self.max_delay, max(d, default=0)))
        if not (0 <= self.min_delay <= self.max_delay) and self.kind == "uniform":
            raise ValueError(
                f"uniform needs 0 <= min_delay <= max_delay, got "
                f"[{self.min_delay}, {self.max_delay}]"
            )
        # the fixed table on each device it was asked for: copied once, so
        # that a round makes no host-to-device copy
        object.__setattr__(self, "_tables", {})

    @property
    def draws(self) -> bool:
        """True when :meth:`draw` draws from its generator."""
        return self.kind in ("uniform", "geometric")

    def draw(self, num_clients: int, generator: Optional[torch.Generator],
             device="cpu") -> torch.Tensor:
        """``[K]`` int32 delays for the clients that re-download this round
        (drawn for every client; the engine keeps those of the clients that
        arrived), on ``device``, drawn from ``generator``: the round's
        ``ARRIVAL`` generator, which the engine passes in. The zero and
        fixed kinds draw nothing (``generator`` may then be None)."""
        k, device = int(num_clients), torch.device(device)
        if self.kind == "zero":
            return torch.zeros(k, dtype=torch.int32, device=device)
        if self.kind == "fixed":
            if len(self.delays) != k:
                raise ValueError(f"fixed delays length {len(self.delays)} != num_clients {k}")
            if device not in self._tables:
                self._tables[device] = torch.tensor(self.delays, dtype=torch.int32).to(device)
            return self._tables[device]
        if self.kind == "uniform":
            return torch.randint(self.min_delay, self.max_delay + 1, (k,), generator=generator,
                                 device=device, dtype=torch.int32)
        u = torch.rand(k, generator=generator, device=device) * (1.0 - U_MIN) + U_MIN
        return geometric_delays(torch.clamp_min(u, U_MIN), self.mean_delay, self.max_delay)

    @property
    def history_len(self) -> int:
        """Rows of the engine's ring of published params: a client arriving
        after ``d <= max_delay`` rounds trains from the model published
        ``d`` rounds before."""
        return int(self.max_delay) + 1

    def __repr__(self) -> str:
        if self.kind == "zero":
            return "ArrivalProcess(zero)"
        if self.kind == "fixed":
            return f"ArrivalProcess(fixed, max={self.max_delay})"
        if self.kind == "uniform":
            return f"ArrivalProcess(uniform[{self.min_delay},{self.max_delay}])"
        return f"ArrivalProcess(geometric(mean={self.mean_delay}, max={self.max_delay}))"
