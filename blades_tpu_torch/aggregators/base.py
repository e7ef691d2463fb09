"""Aggregator protocol.

Counterpart: ``blades_tpu/aggregators/base.py:35-306`` (``Aggregator``). An
aggregator is a function over the on-device ``[K, D]`` update matrix,

    aggregate(updates, state, **ctx) -> (aggregated [D], new_state)

with any cross-round state threaded explicitly. ``__call__`` is the
convenience wrapper with reference-call parity (a stacked matrix, a list of
vectors, or a list of client handles) that keeps the state itself.

The context an aggregator may read: ``byz_mask``, ``trusted_mask``
(FLTrust), ``params_flat`` (ByzantineSGD), ``generator`` (the round's
``utils/rng.py:AGG`` generator, where the JAX package passes ``key``; DnC
draws from it) and ``weights`` (GeoMed's initial client weights).

The mask-aware path (``aggregate_masked``, JAX ``:89-137``) aggregates over
the participating clients of a ``[K]`` mask (``blades_tpu_torch.faults``);
each registered aggregator implements ``_masked_aggregate``.

The forensics (JAX ``:139-159``, ``:260-283``): ``diagnostics`` is the
per-round record of what the defense decided (trimmed mean's trim counts,
Krum's scores and selection, centered clipping's clip norms, FLTrust's
trust scores; ``{}`` by default), a dict of device tensors with no host
sync; ``aggregate_with_diagnostics`` and
``aggregate_masked_with_diagnostics`` return it beside the aggregate. The
masked form's diagnostics run on the sanitized matrix, so an excluded NaN
row cannot NaN them.

The streaming protocol (JAX ``:160-260``) consumes the update matrix as one
ordered pass of sanitized ``[chunk, D]`` slabs (``streaming_init``,
``streaming_update`` per chunk, ``streaming_finalize``), so the streaming
round never holds ``[K, D]``; ``aggregate_streaming`` drives it over a dense
matrix exactly as the engine does. :class:`TwoLevelStreaming` (JAX
``:309-372``) is the generic form: the defense chunk by chunk, then again
over the ``[num_chunks, D]`` stack of chunk aggregates. A defense without a
streaming form names its reason in ``streaming_optouts``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from blades_tpu_torch.ops.streaming import chunk_layout, stack_init, stack_write


class Aggregator:
    """Base class for robust aggregators. Construction-time hyperparameters
    are plain Python attributes."""

    #: set by subclasses that carry state across rounds
    stateful: bool = False

    #: certification-contract opt-outs, ``{contract: reason}`` (class-level,
    #: never mutated; an instance may shadow it, as ``Clustering`` does per
    #: metric): the contracts of ``audit/contracts.py`` a defense fails by
    #: design, and why
    audit_optouts: dict = {}

    #: streaming-protocol opt-outs, ``{"streaming": reason}``: why a defense
    #: cannot consume the update matrix as one pass of ``[chunk, D]`` slabs
    streaming_optouts: dict = {}

    #: True when the streaming form computes the dense estimator (up to the
    #: order of the chunk sums); False for a two-level form
    streaming_exact: bool = False

    #: None when ``aggregate`` and ``_masked_aggregate`` can be captured in
    #: a CUDA graph (no host sync, no generator state set inside the call),
    #: else why not; an engine with such a defense runs its round blocks
    #: eagerly (``RoundEngine.graph_block_reason``)
    graph_unsafe_reason: Optional[str] = None

    def init_state(self, num_clients: int, dim: int) -> Any:
        """Initial carry for stateful aggregators; ``()`` when stateless."""
        return ()

    def column_separable(self, num_clients: int) -> bool:
        """True where :meth:`aggregate` of ``[K, D]`` is coordinate-wise and
        stateless, so that a sharding plan may run it in model-axis column
        blocks (``parallel/mesh.py:ShardingPlan.aggregate_columns``); only
        the trimmed mean's kernel route says so."""
        return False

    def aggregate(
        self,
        updates: torch.Tensor,
        state: Any = (),
        *,
        byz_mask: Optional[torch.Tensor] = None,
        trusted_mask: Optional[torch.Tensor] = None,
        params_flat: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        weights: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    # -- partial participation ---------------------------------------------------

    def aggregate_masked(
        self, updates: torch.Tensor, state: Any = (), *,
        mask: Optional[torch.Tensor] = None, **ctx,
    ) -> Tuple[torch.Tensor, Any]:
        """:meth:`aggregate` over the clients that ``mask`` (boolean ``[K]``)
        marks as participating. A masked-out row cannot influence the
        result: its payload may be stale, NaN or Inf, and it is zeroed before
        :meth:`_masked_aggregate` sees it. ``mask=None`` is :meth:`aggregate`
        itself."""
        if mask is None:
            return self.aggregate(updates, state, **ctx)
        mask, safe = self._sanitize(updates, mask)
        return self._masked_aggregate(safe, state, mask=mask, **ctx)

    @staticmethod
    def _sanitize(updates, mask):
        """The mask as bool on the updates' device, and the updates with
        masked-out rows set to 0 by ``where``: multiplying by the mask would
        keep a NaN row NaN (``NaN * 0`` is NaN)."""
        mask = torch.as_tensor(mask).to(updates.device, torch.bool)
        return mask, torch.where(mask[:, None], updates, 0.0)

    def _masked_aggregate(
        self, updates: torch.Tensor, state: Any, *, mask: torch.Tensor, **ctx
    ) -> Tuple[torch.Tensor, Any]:
        """The mask-aware core; ``updates`` arrives with masked-out rows
        zeroed. Every registered aggregator overrides it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement mask-aware "
            "aggregation (_masked_aggregate)"
        )

    # -- S experiments at once (ExperimentBatch(mode="vmap")) --------------------

    def aggregate_masked_batched(
        self, updates: torch.Tensor, states: list, *, masks: Optional[torch.Tensor] = None,
        ctxs: list, diagnostics: bool = False,
    ) -> Tuple[torch.Tensor, list, Optional[list]]:
        """S experiments' :meth:`aggregate_masked` (and, with
        ``diagnostics``, their :meth:`diagnostics`): ``updates`` ``[S, K,
        D]``, ``states`` and ``ctxs`` (each experiment's context: its
        generator, its flat params) lists of S, ``masks`` ``[S, K]`` or
        None. Returns ``([S, D] aggregates, new states, diagnostics or
        None)``. By default each experiment runs on its row ``s``; a defense
        with a batched form overrides this (mean, median, trimmed mean)."""
        aggs, new_states, diags = [], [], []
        for s, (state, ctx) in enumerate(zip(states, ctxs)):
            mask = None if masks is None else masks[s]
            if diagnostics:
                agg, state, diag = self.aggregate_masked_with_diagnostics(
                    updates[s], state, mask=mask, **ctx)
                diags.append(diag)
            else:
                agg, state = self.aggregate_masked(updates[s], state, mask=mask, **ctx)
            aggs.append(agg)
            new_states.append(state)
        return torch.stack(aggs), new_states, diags if diagnostics else None

    def _dense_batched(self, agg, updates, states, ctxs, diagnostics):
        """The return of :meth:`aggregate_masked_batched` for a stateless
        defense's batched unmasked ``[S, D]`` aggregate ``agg``; the
        diagnostics per experiment."""
        diags = ([self.diagnostics(updates[s], st, **ctx)
                  for s, (st, ctx) in enumerate(zip(states, ctxs))] if diagnostics else None)
        return agg, list(states), diags

    # -- forensics ----------------------------------------------------------------

    def diagnostics(self, updates: torch.Tensor, state: Any = (), **ctx) -> dict:
        """What the defense decided this round, as a dict of device tensors
        of fixed shape (no host sync, so a captured round records it too);
        ``state`` is the round's incoming aggregator state. Default: none."""
        return {}

    def aggregate_with_diagnostics(
        self, updates: torch.Tensor, state: Any = (), **ctx
    ) -> Tuple[torch.Tensor, Any, dict]:
        """:meth:`aggregate` and :meth:`diagnostics` over the same inputs
        (the engine's ``collect_diagnostics`` path)."""
        agg, new_state = self.aggregate(updates, state, **ctx)
        return agg, new_state, self.diagnostics(updates, state, **ctx)

    def aggregate_masked_with_diagnostics(
        self, updates: torch.Tensor, state: Any = (), *,
        mask: Optional[torch.Tensor] = None, **ctx,
    ) -> Tuple[torch.Tensor, Any, dict]:
        """:meth:`aggregate_masked` and :meth:`diagnostics`; the diagnostics
        run on the sanitized matrix (masked-out rows zeroed)."""
        if mask is None:
            return self.aggregate_with_diagnostics(updates, state, **ctx)
        mask, safe = self._sanitize(updates, mask)
        agg, new_state = self._masked_aggregate(safe, state, mask=mask, **ctx)
        return agg, new_state, self.diagnostics(safe, state, mask=mask, **ctx)

    # -- streaming (chunk-scanned) aggregation ----------------------------------
    #
    #   sstate = agg.streaming_init(K, num_chunks, chunk_size, D, state, device=)
    #   for j in range(num_chunks):
    #       sstate = agg.streaming_update(sstate, slab_j, chunk_mask=m_j,
    #                                     chunk_index=j, **ctx)
    #   agg_vec, new_state = agg.streaming_finalize(sstate, state, **ctx)
    #
    # Slabs arrive sanitized (masked-out rows zeroed by `_sanitize`), every
    # slab has `chunk_size` rows, and the chunk mask covers both the rows a
    # fault took out and the padding of the final chunk.

    def supports_streaming(self) -> bool:
        """True when this aggregator implements the streaming protocol."""
        return type(self).streaming_update is not Aggregator.streaming_update

    def streaming_init(self, num_clients: int, num_chunks: int, chunk_size: int, dim: int,
                       state: Any = (), *, device="cpu") -> Any:
        """The initial stream state on ``device``; ``state`` is the
        aggregator's cross-round state at the round's start."""
        raise NotImplementedError(self._no_streaming_msg())

    def streaming_update(self, sstate: Any, chunk_updates: torch.Tensor, *,
                         chunk_mask: torch.Tensor, chunk_index: int, **ctx) -> Any:
        """Fold one sanitized ``[chunk, D]`` slab into the stream state."""
        raise NotImplementedError(self._no_streaming_msg())

    def streaming_finalize(self, sstate: Any, state: Any = (), **ctx) -> Tuple[torch.Tensor, Any]:
        """``(aggregate [D], new cross-round state)`` once every chunk is in."""
        raise NotImplementedError(self._no_streaming_msg())

    def _no_streaming_msg(self) -> str:
        reason = self.streaming_optouts.get("streaming")
        why = f" ({reason})" if reason else ""
        return (
            f"{type(self).__name__} does not implement streaming aggregation{why}; "
            "use the dense path or a streaming-capable defense"
        )

    def aggregate_streaming(
        self, updates: torch.Tensor, state: Any = (), *, num_chunks: int = 1,
        mask: Optional[torch.Tensor] = None, **ctx,
    ) -> Tuple[torch.Tensor, Any]:
        """The streaming protocol over a dense ``[K, D]`` matrix, chunked as
        the streaming round chunks it: ``ceil(K / num_chunks)`` rows a chunk,
        the final chunk padded with zero rows that its mask leaves out, each
        slab sanitized, then init, one update per chunk, finalize."""
        k, d = updates.shape
        c, chunk, pad = chunk_layout(k, num_chunks)
        dev = updates.device
        mask = (torch.ones(k, dtype=torch.bool, device=dev) if mask is None
                else torch.as_tensor(mask).to(dev, torch.bool))
        if pad:
            updates = torch.cat([updates, updates.new_zeros(pad, d)])
            mask = torch.cat([mask, mask.new_zeros(pad)])
        sstate = self.streaming_init(k, c, chunk, d, state, device=dev)
        for j in range(c):
            rows = slice(j * chunk, (j + 1) * chunk)
            m_c, safe = self._sanitize(updates[rows], mask[rows])
            sstate = self.streaming_update(sstate, safe, chunk_mask=m_c, chunk_index=j, **ctx)
        return self.streaming_finalize(sstate, state, **ctx)

    # -- host-side convenience ------------------------------------------------

    def _coerce(self, inputs) -> torch.Tensor:
        """A stacked ``[K, D]`` matrix from a matrix, a list of vectors, or a
        list of client handles (reference ``_get_updates``)."""
        if isinstance(inputs, (list, tuple)):
            if len(inputs) and hasattr(inputs[0], "get_update"):
                inputs = [c.get_update() for c in inputs]
            return torch.stack([torch.as_tensor(u) for u in inputs], dim=0)
        return torch.as_tensor(inputs)

    def __call__(self, inputs, **ctx) -> torch.Tensor:
        updates = self._coerce(inputs)
        if not hasattr(self, "_state"):
            self._state = self.init_state(*updates.shape)
        agg, self._state = self.aggregate(updates, self._state, **ctx)
        return agg

    def reset(self) -> None:
        if hasattr(self, "_state"):
            del self._state

    def __repr__(self) -> str:
        return type(self).__name__


class TwoLevelStreaming:
    """The generic two-level streaming form: the defense over each chunk,
    then again over the ``[num_chunks, D]`` stack of chunk aggregates, empty
    chunks masked out. It is not the dense estimator: a byzantine minority
    must capture a chunk and then a majority of chunk aggregates.

    Mix in before :class:`Aggregator`; override :meth:`_chunk_aggregate`
    (default: the defense's ``_masked_aggregate`` from an empty state) or
    :meth:`_combine_chunk_aggs` (default: the same over the stack). A level
    of one row is its own aggregate (``chunk_size == 1``, ``num_chunks ==
    1``). Participant counts stay 0-d device tensors.
    """

    def streaming_init(self, num_clients, num_chunks, chunk_size, dim, state=(), *,
                       device="cpu"):
        return {
            "aggs": stack_init(num_chunks, (dim,), device=device),
            "counts": torch.zeros(num_chunks, dtype=torch.int32, device=device),
        }

    def streaming_update(self, sstate, chunk_updates, *, chunk_mask, chunk_index, **ctx):
        n = chunk_mask.to(torch.int32).sum(dtype=torch.int32)
        if chunk_updates.shape[0] == 1:
            agg = chunk_updates[0]
        else:
            agg = self._chunk_aggregate(chunk_updates, chunk_mask=chunk_mask, **ctx)
        agg = torch.where(n > 0, agg, torch.zeros_like(agg))
        return {
            "aggs": stack_write(sstate["aggs"], chunk_index, agg),
            "counts": stack_write(sstate["counts"], chunk_index, n),
        }

    def streaming_finalize(self, sstate, state=(), **ctx):
        aggs, counts = sstate["aggs"], sstate["counts"]
        if aggs.shape[0] == 1:
            return torch.where(counts[0] > 0, aggs[0], torch.zeros_like(aggs[0])), state
        return self._combine_chunk_aggs(aggs, counts, state, **ctx)

    def _chunk_aggregate(self, slab, *, chunk_mask, **ctx):
        agg, _ = self._masked_aggregate(slab, (), mask=chunk_mask, **ctx)
        return agg

    def _combine_chunk_aggs(self, aggs, counts, state, **ctx):
        agg, _ = self._masked_aggregate(aggs, (), mask=counts > 0, **ctx)
        return torch.where(counts.sum() > 0, agg, torch.zeros_like(agg)), state
