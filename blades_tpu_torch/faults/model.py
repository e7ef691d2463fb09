"""Seeded system-fault injection for the federated round.

Counterpart: ``blades_tpu/faults/model.py:33-326`` (``FaultModel``: its
validation, ``has_stragglers``, ``value_corruption``, ``init_state``,
``static_fingerprint``, ``apply``, ``plan_streaming``, ``corrupt_chunk`` and
``__repr__``). A fault model turns the
post-attack ``[K, D]`` update matrix into the matrix the server received
and a boolean ``[K]`` mask of the clients it aggregates: dropped clients
are masked out, a straggler re-sends its last fresh update while that is at
most ``max_staleness`` rounds old (and is dropped after), corrupt clients'
delivered rows become NaN, Inf or bit-flip noise, and the non-finite guard
masks out every row holding a NaN or Inf.

The round's random draws come from :func:`draw_faults` on the round's
``utils/rng.py:FAULT`` generator, in the order of the JAX package's
``split(key, 4)`` (dropout ``[K]``, straggle ``[K]``, corrupt ``[K]``,
bitflip ``[K, D]``), each drawn only where the JAX package draws it, so a
test can hand the same draws to ``jax.random.bernoulli`` in call order.
:meth:`FaultModel.apply` is torch ops on the updates' device with no
error path and no read of the device; its counters are 0-d int32 tensors.
The straggler buffer stays float32 whatever the model's compute dtype.

The streaming round (JAX ``:249-309``) splits the pass in two:
:meth:`FaultModel.plan_streaming` makes the ``[K]`` decisions (who dropped,
who is corrupt) from the same draws, in the same order, as ``apply``, so a
streaming round's counters equal the dense round's on the same seed; and
:meth:`FaultModel.corrupt_chunk` corrupts one ``[chunk, D]`` slab, drawing
the bit-flip pattern per chunk from the chunk's own generator, as the JAX
package draws it from ``fold_in(corrupt_key, chunk)``. Stragglers have no
streaming form: their replay buffer is ``[K, D]`` state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _bernoulli(p: float, shape, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.bool,
                       device=generator.device).bernoulli_(p, generator=generator)


def draw_faults(
    fm: "FaultModel", num_clients: int, dim: Optional[int], generator: torch.Generator
) -> Dict[str, Optional[torch.Tensor]]:
    """The round's random draws on ``generator``'s device: ``drop`` (``[K]``,
    with a positive ``dropout_rate`` and no schedule), ``straggle``
    (``[K]``, with stragglers), ``corrupt`` (``[K]``, with a positive
    ``corrupt_rate``) and ``bitflip`` (``[K, D]``, in ``bitflip`` mode), in
    that order; None where the JAX package draws nothing. ``dim=None``
    leaves the ``[K, D]`` draw out (the streaming round draws it per
    chunk)."""
    k = num_clients
    return {
        "drop": (_bernoulli(fm.dropout_rate, (k,), generator)
                 if fm.participation_schedule is None and fm.dropout_rate > 0.0 else None),
        "straggle": (_bernoulli(fm.straggler_rate, (k,), generator)
                     if fm.has_stragglers else None),
        "corrupt": (_bernoulli(fm.corrupt_rate, (k,), generator)
                    if fm.corrupt_rate > 0.0 else None),
        "bitflip": (_bernoulli(fm.bitflip_frac, (k, dim), generator)
                    if fm.corrupt_mode == "bitflip" and dim is not None else None),
    }


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-round fault plan: who participates, who is stale, what is corrupt.

    Parameters
    ----------
    dropout_rate : i.i.d. per-client probability of dropping out each round.
    participation_schedule : optional ``[period, K]`` bool array, a
        deterministic participation plan (row ``r % period`` is round
        ``r``'s availability); overrides ``dropout_rate``.
    straggler_rate : probability that a client that did not drop is a
        straggler this round. It re-sends its buffered update from the last
        round it reported fresh, while that is at most ``max_staleness``
        rounds old; a straggler with no such update is dropped.
    max_staleness : staleness bound (rounds) on the replay buffer.
    corrupt_rate : i.i.d. probability that a delivered row is corrupted.
    corrupt_clients : client ids whose delivered rows are always corrupted.
    corrupt_mode : ``"nan"`` | ``"inf"`` | ``"bitflip"``. ``nan``/``inf``
        overwrite the whole row; ``bitflip`` flips the sign and scales by
        ``bitflip_scale`` a random ``bitflip_frac`` of the coordinates.
    guard_nonfinite : the server-side guard: rows holding any NaN or Inf
        are taken out of the participation mask before aggregation.
    """

    dropout_rate: float = 0.0
    participation_schedule: Optional[Any] = None
    straggler_rate: float = 0.0
    max_staleness: int = 1
    corrupt_rate: float = 0.0
    corrupt_clients: Tuple[int, ...] = ()
    corrupt_mode: str = "nan"
    bitflip_scale: float = 2.0 ** 15
    bitflip_frac: float = 0.01
    guard_nonfinite: bool = True

    def __post_init__(self):
        if self.corrupt_mode not in ("nan", "inf", "bitflip"):
            raise ValueError(f"unknown corrupt_mode {self.corrupt_mode!r}")
        if self.participation_schedule is not None:
            sched = np.asarray(self.participation_schedule, dtype=bool)
            if sched.ndim != 2:
                raise ValueError("participation_schedule must be [period, num_clients]")
            object.__setattr__(self, "participation_schedule", sched)
        object.__setattr__(self, "corrupt_clients", tuple(int(c) for c in self.corrupt_clients))

    # -- state ---------------------------------------------------------------

    @property
    def has_stragglers(self) -> bool:
        return self.straggler_rate > 0.0

    @property
    def value_corruption(self) -> bool:
        """True when whole-row NaN/Inf corruption is configured; the fill
        value then rides the state (``init_state``), as in the JAX package,
        where that lets the NaN and Inf configurations share one program."""
        return self.corrupt_mode in ("nan", "inf") and bool(
            self.corrupt_rate > 0.0 or self.corrupt_clients
        )

    @property
    def _fill_value(self) -> float:
        return float("nan") if self.corrupt_mode == "nan" else float("inf")

    def init_state(self, num_clients: int, dim: int, device="cpu") -> Any:
        """The straggler replay buffer (``stale [K, D]`` float32, ``age``
        int32, ``has`` bool) when stragglers are on, and the ``fill`` scalar
        when value corruption is; ``()`` when neither is."""
        state = {}
        if self.has_stragglers:
            state.update({
                "stale": torch.zeros(num_clients, dim, dtype=torch.float32, device=device),
                "age": torch.zeros(num_clients, dtype=torch.int32, device=device),
                "has": torch.zeros(num_clients, dtype=torch.bool, device=device),
            })
        if self.value_corruption:
            state["fill"] = torch.full((), self._fill_value, dtype=torch.float32, device=device)
        return state if state else ()

    def static_fingerprint(self) -> Any:
        """Every field that shapes the round's program, with the NaN/Inf
        fill collapsed to ``"value"`` when it rides the state
        (``blades_tpu.sweeps`` keys warm engines on it)."""
        fields = dataclasses.asdict(self)
        if self.value_corruption:
            fields["corrupt_mode"] = "value"
        sched = fields.get("participation_schedule")
        if sched is not None:
            fields["participation_schedule"] = [[bool(v) for v in row] for row in np.asarray(sched)]
        return fields

    # -- the fault pass ---------------------------------------------------------

    def apply(
        self, updates: torch.Tensor, state: Any, generator: torch.Generator, round_idx,
        draws: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Any, dict]:
        """This round's faults on the post-attack update matrix.

        Returns ``(updates, participation_mask, new_state, diagnostics)``:
        the matrix the server received (stale replays and corruption in
        it), the boolean ``[K]`` mask of the rows it aggregates, the advanced
        state, and 0-d int32 counters (participants, dropped, stale
        replays, stragglers dropped past ``max_staleness``, corrupted rows,
        rows excluded by the non-finite guard). ``round_idx``: an int or the
        round's 0-d device index (it picks the schedule's row). ``draws``:
        this round's :func:`draw_faults`, drawn here from ``generator`` when
        None.
        """
        k, d = updates.shape
        dev = updates.device
        if draws is None:
            draws = draw_faults(self, k, d, generator)
        draws = {n: None if t is None else t.to(dev) for n, t in draws.items()}
        zeros = torch.zeros(k, dtype=torch.bool, device=dev)
        drop, corrupt = self._decisions(draws, k, round_idx, dev)

        if self.has_stragglers:
            st = {n: t.to(dev) for n, t in state.items()}
            straggle = draws["straggle"] & ~drop
            age = st["age"] + 1  # the buffered update ages one round
            stale_ok = straggle & st["has"] & (age <= self.max_staleness)
            fresh = ~drop & ~straggle
            out = torch.where(stale_ok[:, None], st["stale"].to(updates.dtype), updates)
            part = fresh | stale_ok
            # init_state's key order, so a new state has the layout of the
            # one it replaces (a captured round writes it back in place)
            new_state = {
                "stale": torch.where(fresh[:, None], updates.to(torch.float32), st["stale"]),
                "age": torch.where(fresh, 0, age).to(torch.int32),
                "has": st["has"] | fresh,
                **({"fill": st["fill"]} if "fill" in st else {}),
            }
            n_stale = _count(stale_ok)
            n_expired = _count(straggle & ~stale_ok)
        else:
            fresh = ~drop
            part = fresh
            out = updates
            new_state = state
            n_stale = n_expired = _count(zeros)

        corrupt = corrupt & part  # only delivered payloads arrive corrupted
        if self.value_corruption:
            fill = state["fill"].to(dev) if isinstance(state, dict) and "fill" in state else (
                torch.full((), self._fill_value, dtype=torch.float32, device=dev))
            out = torch.where(corrupt[:, None], fill.to(out.dtype), out)
        elif self.corrupt_mode == "bitflip":
            # sign flip and a power-of-two scale on a subset of coordinates
            out = torch.where(draws["bitflip"] & corrupt[:, None], -self.bitflip_scale * out, out)
        # (nan/inf mode with no corruption configured: nothing is corrupted)

        excluded = zeros
        if self.guard_nonfinite:
            finite = torch.isfinite(out).all(dim=1)
            excluded = part & ~finite
            part = part & finite

        diag = {
            "participants": _count(part),
            "dropped": _count(drop),
            "stale_replayed": n_stale,
            "stragglers_expired": n_expired,
            "corrupted": _count(corrupt),
            "excluded_nonfinite": _count(excluded),
        }
        return out, part, new_state, diag

    # -- the streaming round's fault pass --------------------------------------

    def _decisions(self, draws, k: int, round_idx, dev) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(dropped, corrupt)``, ``[K]`` each, from the round's draws (on
        ``dev``), the schedule and the corrupt client ids; corruption not
        yet restricted to the rows delivered."""
        zeros = torch.zeros(k, dtype=torch.bool, device=dev)
        if self.participation_schedule is not None:
            drop = ~self._schedule_row(round_idx, dev)
        elif self.dropout_rate > 0.0:
            drop = draws["drop"]
        else:
            drop = zeros
        corrupt = zeros
        if self.corrupt_rate > 0.0:
            corrupt = corrupt | draws["corrupt"]
        if self.corrupt_clients:
            rows = torch.arange(k, device=dev)
            for c in self.corrupt_clients:  # an id outside 0..K-1 matches no row
                corrupt = corrupt | (rows == c)
        return drop, corrupt

    def plan_streaming(
        self, num_clients: int, generator: torch.Generator, round_idx,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The streaming round's ``[K]`` decisions on the generator's device,
        ``(participation, dropped, corrupt)``, from the draws ``apply``
        takes (:func:`draw_faults` with ``dim=None``). Raises with
        stragglers."""
        if self.has_stragglers:
            raise ValueError(
                "straggler replay buffers are [K, D] state; the streaming "
                "round supports participation/corruption faults only"
            )
        draws = draw_faults(self, num_clients, None, generator)
        drop, corrupt = self._decisions(draws, num_clients, round_idx, generator.device)
        return ~drop, drop, corrupt & ~drop

    def corrupt_chunk(
        self, slab: torch.Tensor, corrupt: torch.Tensor, generator: torch.Generator,
        fill: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One ``[chunk, D]`` slab with its corrupt rows (``corrupt``, the
        chunk's slice of the planned mask) overwritten by ``fill`` (the fault
        state's, or the mode's constant) in NaN/Inf mode, or bit-flipped in
        ``bitflip`` mode on a pattern drawn from ``generator``, which is
        drawn whether or not a row of the chunk is corrupt, as in JAX."""
        if self.corrupt_mode in ("nan", "inf"):
            value = (torch.full((), self._fill_value, dtype=torch.float32, device=slab.device)
                     if fill is None else fill.to(slab.device))
            return torch.where(corrupt[:, None], value.to(slab.dtype), slab)
        flip = _bernoulli(self.bitflip_frac, slab.shape, generator).to(slab.device)
        return torch.where(flip & corrupt[:, None], -self.bitflip_scale * slab, slab)

    def _schedule_row(self, round_idx, device) -> torch.Tensor:
        """Round ``round_idx``'s row of the schedule on ``device``.
        ``round_idx`` is an int or the round's 0-d device index (the
        engine's, so that a captured round reads the row of the round it
        replays). The schedule is copied to each device once and kept with
        the model, so only the first round waits for a host-to-device
        copy."""
        cache = self.__dict__.setdefault("_schedule_on", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = torch.from_numpy(self.participation_schedule).to(device)
        sched = cache[key]
        if not isinstance(round_idx, torch.Tensor):
            round_idx = torch.full((), int(round_idx), dtype=torch.int64, device=sched.device)
        row = torch.remainder(round_idx.to(sched.device, torch.int64), sched.shape[0])
        return sched.index_select(0, row.view(1))[0]

    def __repr__(self) -> str:
        parts = []
        if self.participation_schedule is not None:
            parts.append(f"schedule[{self.participation_schedule.shape[0]}]")
        elif self.dropout_rate:
            parts.append(f"drop={self.dropout_rate}")
        if self.straggler_rate:
            parts.append(f"straggle={self.straggler_rate}(s<={self.max_staleness})")
        if self.corrupt_rate or self.corrupt_clients:
            parts.append(
                f"corrupt[{self.corrupt_mode}]="
                f"{self.corrupt_rate or list(self.corrupt_clients)}"
            )
        return f"FaultModel({', '.join(parts) or 'noop'})"


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.int32).sum(dtype=torch.int32)
