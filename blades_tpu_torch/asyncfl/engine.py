"""The buffered-asynchronous round body (one tick of the FedBuff server).

Counterpart: ``blades_tpu/asyncfl/engine.py:94-376`` (``async_round``),
which :meth:`blades_tpu_torch.core.RoundEngine.run_round` calls when the
engine was built with ``async_config=``. One tick, every decision a device
tensor and every gate a ``torch.where``, so the tick makes no host sync of
its own:

1. **publish**: when arrivals can lag (``max_delay > 0``), the flat params
   go into row ``t mod h`` of the ``[h, D]`` ring, and each client trains
   from row ``version mod h``, the model it downloaded; the rows are
   gathered per client chunk inside ``_train_clients``, so no ``[K, D]``
   matrix of start params is formed. With ``max_delay == 0`` there is no
   ring, and training is the sync round's;
2. **train, attack, faults**: every client trains, as in the dense round
   (the work of clients that did not arrive is discarded), then the
   attack's ``on_updates`` and the fault model's ``apply``; a dropped
   arrival is lost;
3. **deposit**: arriving, delivered updates land in their client's slot
   (newest wins), with the download version the staleness is counted from;
4. **fire**: once the buffer holds ``buffer_m`` updates, the registry's
   ``aggregate_masked`` over the rows scaled by the staleness weights
   (``buffer.py``), the server step, and the buffer drained. A tick that
   does not fire leaves the params, the server optimizer state and the
   aggregator state bit-identical; the persistent client state moves only
   in the rows of clients that arrived;
5. **re-download**: arrived clients take version ``t + 1`` and draw a new
   delay (``arrivals.py``).

**The static sync specialization** (JAX ``:113``, ``:162-171``,
``:191-216``): with zero-delay arrivals and no fault model every client
arrives every tick with staleness 0 and every tick fires, so the tick makes
the sync round's own unmasked ``aggregator.aggregate`` call, with no mask,
gate or weight near the defense. ``buffer_m=K``, zero delays and constant
weighting are then bit-identical to the sync round, and the trimmed mean
takes the Hopper kernel; every other configuration takes the masked path
(for the trimmed mean, the masked trimmed mean, not the kernel).

The per-tick counters go to ``engine.last_async_diag`` (0-d tensors), which
the Simulator writes as the ``async`` telemetry record. The forensics (JAX
``:185-250``) run on the rows the defense consumed: with
``collect_diagnostics`` the defense's diagnostics, with an audit monitor
its certificates and fallback on the tick's aggregate, with
``round_metrics`` the metric pack against the aggregate applied. On the
general path they are gated on the fire: a breach on a tick that did not
fire swapped nothing in, and its ``breach`` and ``fallback_used`` read 0.

With a sharding plan (JAX ``:115-146``, ``:182-183``) the tick trains
through the engine's ``_train_clients``, so the clients axis is the dense
round's: each chunk's rows on their mesh rows' devices, each client's
lagged start params moved to its row's device with its rows, and the
``[K, D]`` rows, the buffer and the defense on the primary device. The
static tick's unmasked trimmed mean runs in the plan's model-axis column
blocks (``core/engine.py:RoundEngine._column_blocks``); the masked path
runs whole.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map

from blades_tpu_torch.ops.masked import participant_count as _count
from blades_tpu_torch.ops.pytree import ravel
from blades_tpu_torch.telemetry.metric_pack import pack_dense
from blades_tpu_torch.utils import rng


def _tree_where(pred, new, old):
    """``new`` where the 0-d ``pred`` holds, else ``old``, leaf by leaf."""
    return tree_map(lambda a, b: torch.where(pred, a, b.to(a.device)), new, old)


def _rows_where(mask, new, old):
    """Per client: ``new``'s row where ``mask`` ([K]) holds, else ``old``'s."""

    def pick(a, b):
        return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)

    return tree_map(pick, new, old)


def async_round(engine, state, inputs, streams, steps_batch):
    """One buffered-asynchronous tick (module docstring) as a round body
    (``RoundEngine._round_body``: it yields its training, attack,
    aggregation and server-step requests), with the round's 0-d ``inputs``
    (``core/engine.py:RoundInputs``; the tick index ``t`` is
    ``inputs.round_t``, a device tensor, so that a captured tick reads the
    tick it replays), generators ``streams`` and the batch's local steps
    and batch size ``steps_batch``; returns ``(new state, metrics)`` as
    ``run_round`` does, and sets the engine's
    ``last_updates`` (the matrix the server received this tick, under
    ``keep_updates``), ``last_fault_diag``, ``last_async_diag`` and the
    forensics ``last_diagnostics``, ``last_audit_diag`` and
    ``last_metric_pack``."""
    from blades_tpu_torch.core.engine import RoundState, TrainRequest

    cfg, astate = engine.async_config, state.async_state
    k, t, dev = engine.num_clients, inputs.round_t, engine.device
    static_sync = cfg.arrivals.kind == "zero" and engine.fault_model is None
    flat = ravel(state.params, engine.layout)

    # -- 1. publish the current model, and each client's download ----------
    hist, lag = astate.get("hist"), None
    if hist is not None:
        h = hist.shape[0]
        hist = hist.index_copy(0, torch.remainder(t, h).view(1), flat[None])
        lag = (hist, torch.remainder(astate["version"], h))

    # -- 2. every client trains; the attack and the faults as in the dense round
    updates, losses, top1s, new_client_opt = (yield "train", TrainRequest(
        state.params, flat, state.client_opt_state, inputs.client_lr,
        engine._draw_noise(streams(rng.DROPOUT), *steps_batch), lag=lag)).pop()
    updates = torch.nan_to_num(updates)
    updates, attack_state = (yield "attack", (
        updates, engine.byz_mask, streams(rng.ATTACK), state.attack_state)).pop()
    sent = updates
    fault_state, part_mask, fault_diag = state.fault_state, None, None
    if engine.fault_model is not None:
        updates, part_mask, fault_state, fault_diag = engine.fault_model.apply(
            updates, state.fault_state, streams(rng.FAULT), t,
        )

    # -- 3. deposit into the per-client slots -------------------------------
    if static_sync:
        arriving = torch.ones(k, dtype=torch.bool, device=dev)
        buf, buf_mask, buf_version = updates, arriving, astate["version"]
        n_deposit = count = torch.full((), k, dtype=torch.int32, device=dev)
        fired = torch.ones((), dtype=torch.bool, device=dev)  # buffer_m <= K
    else:
        arriving = astate["countdown"] <= 0
        deposit = arriving if part_mask is None else arriving & part_mask
        buf = torch.where(deposit[:, None], updates, astate["buf"])
        buf_mask = astate["buf_mask"] | deposit
        buf_version = torch.where(deposit, astate["version"], astate["buf_version"])
        n_deposit, count = _count(deposit), _count(buf_mask)
        fired = count >= engine.async_buffer_m

    # -- 4. staleness-weighted aggregation, gated on the fire ---------------
    agg_ctx = dict(trusted_mask=engine.trusted_mask, params_flat=flat,
                   generator=streams(rng.AGG))
    if static_sync:
        # staleness 0 and weight 1 by construction: the sync round's
        # unmasked calls (mask None)
        tau = torch.zeros(k, dtype=torch.int32, device=dev)
        agg_mask, n_agg, mask = buf_mask, count, None
        weights = torch.ones(k, dtype=torch.float32, device=dev)
        weighted = buf
    else:
        tau = (t - buf_version).to(torch.int32)
        agg_mask, weights = cfg.staleness_mask_weights(tau, buf_mask)
        weighted = buf if cfg.weights_are_identity else buf * weights[:, None]
        n_agg, mask = _count(agg_mask), agg_mask
    audit_diag = None
    agg, agg_state, agg_diag = (yield "aggregate", (weighted, state.agg_state, mask, agg_ctx)).pop()
    if not static_sync:
        # an empty aggregated set applies the zero update
        agg = torch.where(n_agg > 0, agg, torch.zeros_like(agg))
    if engine.audit_monitor is not None:
        # the certificates over the (weighted) rows the defense consumed
        agg, audit_diag = engine.audit_monitor.apply(
            weighted, agg, mask=mask, byz_mask=engine.byz_mask,
            **engine._fallback_ctx(agg_ctx, streams))
    if not static_sync:
        # so does a tick that does not fire
        agg = torch.where(fired, agg, torch.zeros_like(agg))
        agg_state = _tree_where(fired, agg_state, state.agg_state)
        if audit_diag is not None:
            # a breach on a tick that never fired swapped nothing in
            fired_i = fired.to(torch.int32)
            audit_diag["breach"] = audit_diag["breach"] * fired_i
            audit_diag["fallback_used"] = audit_diag["fallback_used"] * fired_i
            audit_diag["agg_norm"] = torch.sqrt((agg * agg).sum())  # the monitor's norm
    metric_pack = None
    if engine.round_metrics:
        # the rows the defense consumed, against the aggregate applied
        metric_pack = pack_dense(weighted, agg_mask, engine.byz_mask, agg,
                                 engine.client_chunks, engine.chunk_size)
    del weighted

    params, server_opt_state = (yield "server", (state.params, state.server_opt_state,
                                                inputs.server_lr, agg)).pop()
    if not static_sync:
        params = _tree_where(fired, params, state.params)
        server_opt_state = _tree_where(fired, server_opt_state, state.server_opt_state)
        if engine.client_opt.persist:
            # only clients that arrived really trained this tick
            new_client_opt = _rows_where(arriving, new_client_opt, state.client_opt_state)

    # -- 5. drain on fire; arrived clients re-download and draw a delay ------
    new_delays = cfg.arrivals.draw(
        k, streams(rng.ARRIVAL) if cfg.arrivals.draws else None, device=dev)
    fired_i = fired.to(torch.int32)
    new_astate = dict(astate)
    new_astate.update(
        buf=buf,
        buf_mask=buf_mask & ~fired,
        buf_version=buf_version,
        version=torch.where(arriving, t + 1, astate["version"]).to(torch.int32),
        countdown=torch.where(arriving, new_delays,
                              torch.clamp_min(astate["countdown"] - 1, 0)).to(torch.int32),
        fires=astate["fires"] + fired_i,
    )
    if hist is not None:
        new_astate["hist"] = hist

    some = fired & (n_agg > 0)
    engine.last_async_diag = {
        "arrivals": _count(arriving),
        "deposited": n_deposit,
        "buffer_count": count,
        "fired": fired_i,
        "aggregated": torch.where(fired, n_agg, 0).to(torch.int32),
        "fires_total": new_astate["fires"],
        "mean_staleness": torch.where(
            some,
            (tau.to(torch.float32) * agg_mask.to(torch.float32)).sum()
            / torch.clamp_min(n_agg.to(torch.float32), 1.0),
            0.0),
        "max_staleness": torch.where(fired, torch.where(agg_mask, tau, 0).max(), 0).to(
            torch.int32),
        "stale_excluded": _count(buf_mask & ~agg_mask),
        "weight_min": torch.where(
            some, torch.where(agg_mask, weights, torch.inf).min(), 1.0),
    }
    engine.last_updates = updates if engine.keep_updates else None
    engine.last_fault_diag = fault_diag
    engine.last_diagnostics = agg_diag
    engine.last_audit_diag = audit_diag
    engine.last_metric_pack = metric_pack
    metrics = engine._metrics(losses, top1s, sent.var(dim=0, correction=0), agg)
    new_state = RoundState(
        params=params,
        server_opt_state=server_opt_state,
        client_opt_state=new_client_opt,
        agg_state=agg_state,
        attack_state=attack_state,
        round_idx=state.round_idx + 1,
        fault_state=fault_state,
        async_state=new_astate,
    )
    return new_state, metrics
