"""The federated round engine: the dense synchronous round and the
streaming round.

Counterpart: ``blades_tpu/core/engine.py`` — ``ClientOptSpec`` /
``ServerOptSpec`` (:67-122), ``RoundState`` / ``RoundMetrics`` (:125-153),
``_validate_streaming`` (:399-434), ``peak_update_bytes`` (:436-452),
``RoundEngine.init`` (:456), ``_local_update`` (:569-625),
``_train_clients`` (:638-712), ``_round_dense`` (:714-874, its fault branch
:749-797, diagnostics, audit and metric pack :770-830),
``_round_streaming`` (:876-1100), ``run_round`` (:1113),
``run_block`` (:1203), ``evaluate_per_sample`` (:1344) and
``multistep_lr`` (:1374); the async build checks (:341-363), dispatched to
``blades_tpu_torch/asyncfl/engine.py``.

One call to :meth:`RoundEngine.run_round` runs, on the engine's device:

  1. local training of all K clients from the shared global params: first
     every local step's dropout and DropPath keep-masks for all K clients,
     step after step (one generator per round, ``utils/rng.py:DROPOUT``),
     then, chunk by chunk, the chunk's local steps, each one
     ``torch.func.vmap`` of ``grad_and_value`` over the chunk's clients (the
     loss clamped to ``[0, loss_clamp]`` before the gradient, the chunk's
     rows of the masks vmapped in) and the client optimizer on the
     ``[chunk, ...]`` params;
  2. the update matrix ``[K, D]``: ``ravel(theta_after) - ravel(theta_before)``
     in the JAX package's flat order, then ``nan_to_num``;
  3. the attack's ``on_updates`` rewrite (``on_batch`` and ``on_grads``
     run inside step 1, per chunk);
  4. with a fault model (``blades_tpu_torch.faults``), its ``apply`` on the
     post-attack matrix, drawing from the round's ``FAULT`` generator: the
     matrix the server received and the participation mask;
  5. the aggregator (trimmed mean: the Hopper kernel on a CUDA tensor),
     with the trusted mask, the flat params and the round's ``AGG``
     generator as context; under a fault model its masked form
     (``aggregate_masked``; for trimmed mean stock torch ops, not the
     kernel), and the zero update when no client participated;
  6. with ``collect_diagnostics``, what the defense decided
     (``aggregate_with_diagnostics``, or its masked form); with an
     ``audit_monitor``, its certificates on the aggregate and, on a breach,
     its fallback's aggregate in its place; with ``round_metrics``, the
     metric pack (``telemetry/metric_pack.py``) against the aggregate
     applied. The results are ``last_diagnostics``, ``last_audit_diag`` and
     ``last_metric_pack``, dicts (a ``MetricPack``) of device tensors;
  7. the server step with the aggregate as pseudo-gradient, ``grad := -agg``.

The optimizers port optax's chains literally — ``add_decayed_weights``, then
``trace`` (momentum) or ``scale_by_adam`` — and the engine applies
``p -= lr * u`` itself; ``torch.optim`` orders weight decay and momentum
differently.

With ``streaming=True`` the round never holds the ``[K, D]`` update
matrix: each chunk is trained, padded with zero rows to ``chunk_size`` if it
is the final, short one, and taken through ``nan_to_num``, the attack's
``on_updates`` (on the chunk, with the chunk's own ``ATTACK`` generator), the
running moments of what the clients sent, the fault model's
``corrupt_chunk``, the non-finite guard and ``_sanitize``, into the
aggregator's ``streaming_update`` (and those of the audit monitor and its
fallback, and the metric pack's ``pack_update``); then
``streaming_finalize``, the zero update when no client participated, the
audit's ``streaming_apply``, ``pack_finalize`` and the server step. The fault model's
``[K]`` decisions come first, from ``plan_streaming``. The losses are exact;
the variance metrics come from the one-pass moments. Local training is the
dense round's, mask for mask, so the exact forms (``mean``, centered
clipping with ``n_iter=1``) give the dense round's result.

``ClientOptSpec(persist=True)`` keeps each client's optimizer state (Adam's
moments and count, momentum's trace) across rounds as stacked ``[K, ...]``
tensors in ``RoundState.client_opt_state`` (JAX ``:66-99``, ``:487-500``):
each chunk trains from its rows of it, in the dense and the streaming round,
and the chunks' new rows are concatenated back.

With ``async_config`` (``blades_tpu_torch.asyncfl.AsyncConfig``) a round is
one tick of the buffered-asynchronous (FedBuff) server,
``asyncfl/engine.py:async_round``: clients arrive on a seeded schedule and
train from the model version they downloaded, their updates wait in a
``[K, D]`` buffer in ``RoundState.async_state``, and the server fires once
``buffer_m`` have arrived, each update weighted by its staleness; the tick's
counters are ``self.last_async_diag``.

:meth:`RoundEngine.run_block` runs R rounds with the dataset's sampler
fused in (JAX ``_build_block`` / ``run_block``, :1177-1279). On the card,
where the configuration is graph-safe (:meth:`RoundEngine.graph_block_reason`),
it replays one captured CUDA graph of the round R times
(``core/graphs.py``); elsewhere it runs the R rounds eagerly. The round's
scalars reach it as 0-d device tensors (:class:`RoundInputs`) and its
generators come from one ``utils/rng.py:RoundStreams``, in the eager and
the captured round alike, so a block equals R sequential rounds bit for
bit.

Each round runs inside a ``dispatch`` span of the active telemetry
recorder (``telemetry/recorder.py``): the host's time to enqueue it, not
the device's to run it. ``run_round_donated`` and ``run_block`` also open
a launch window of the dispatch accounting (``telemetry/timeline.py``,
JAX ``blades_tpu/core/engine.py:1141``, ``:1241``), which the caller
closes after its own wait on the card (``Simulator.run``'s ``sync``).
Sharding plans are not ported (``ROADMAP.md`` queue
A, slice 12).

``remat=True`` (the JAX engine's ``jax.checkpoint`` around each client's
loss, ``blades_tpu/core/engine.py:599-607``) wraps the same function, the
clamped loss of one local step, in ``ops/remat.py:remat``: an
``autograd.Function`` with ``setup_context`` and a generated vmap rule whose
backward recomputes the forward under ``torch.func.vjp``
(``torch.utils.checkpoint`` works under ``torch.func.grad`` in neither of
its forms). ``client_chunks`` bounds activation memory too.

Each round body (the dense round, the streaming round, the async tick) is
a generator that yields its local training, the attack's ``on_updates``,
the aggregation and the server step as requests
(:meth:`RoundEngine._round_body`): :meth:`RoundEngine._round` answers one
body's requests, and ``ExperimentBatch(mode="vmap")`` runs S bodies in
lockstep and answers each kind of request once for the S experiments
(``core/batched.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.attackers.base import Attack, NoAttack
from blades_tpu_torch.audit import AuditMonitor
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.ops.pytree import FlatLayout, Params, make_unraveler, ravel
from blades_tpu_torch.ops.remat import remat as remat_fn
from blades_tpu_torch.ops.streaming import (
    chunk_layout,
    moments_init,
    moments_update,
    moments_var,
)
from blades_tpu_torch.telemetry import get_recorder, timeline
from blades_tpu_torch.telemetry.metric_pack import pack_dense, pack_finalize, pack_init, pack_update
from blades_tpu_torch.utils import rng


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; asking for CUDA where there is none raises
    (there is no quiet CPU fallback)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "blades_tpu_torch runs on the GPU unless asked otherwise, and "
            "CUDA is not available here; pass device='cpu' to run on the CPU"
        )
    return device


# -- optimizers: optax's chains, literally -------------------------------------


# Each transform's ``init(params, lead)`` takes the params' leading batch
# shape: ``()`` for the server, ``(n,)`` for n stacked clients.


class _AddDecayedWeights:
    def __init__(self, weight_decay: float):
        self.wd = weight_decay

    def init(self, params, lead=()):
        return ()

    def update(self, grads, state, params):
        return {n: g + self.wd * params[n] for n, g in grads.items()}, state


class _Trace:
    """``optax.trace(decay)``: ``t = g + decay * t``; the update is ``t``."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, params, lead=()):
        return {n: torch.zeros_like(p) for n, p in params.items()}

    def update(self, grads, state, params):
        t = {n: g + self.decay * state[n] for n, g in grads.items()}
        return t, t


class _ScaleByAdam:
    """``optax.scale_by_adam`` with ``eps_root=0``. The count is an int32
    tensor of the leading shape, one per client as optax keeps it under
    ``vmap``, and the bias corrections ``1 - b**count`` are float32, as
    optax computes them."""

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params, lead=()):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        dev = next(iter(params.values())).device
        return (torch.zeros(lead, dtype=torch.int32, device=dev), zeros(), zeros())

    def update(self, grads, state, params):
        count, mu, nu = state
        mu = {n: (1 - self.b1) * g + self.b1 * mu[n] for n, g in grads.items()}
        nu = {n: (1 - self.b2) * g * g + self.b2 * nu[n] for n, g in grads.items()}
        count = count + 1
        c1 = 1 - torch.pow(self.b1, count.to(torch.float32))
        c2 = 1 - torch.pow(self.b2, count.to(torch.float32))

        def per_row(c, g):  # a [n] correction against an [n, ...] leaf
            return c.view(c.shape + (1,) * (g.dim() - c.dim()))

        updates = {
            n: (mu[n] / per_row(c1, g)) / (torch.sqrt(nu[n] / per_row(c2, g)) + self.eps)
            for n, g in grads.items()
        }
        return updates, (count, mu, nu)


class _Chain:
    def __init__(self, parts):
        self.parts = parts

    def init(self, params, lead=()):
        return tuple(p.init(params, lead) for p in self.parts)

    def update(self, grads, state, params):
        new_state = []
        for part, st in zip(self.parts, state):
            grads, st = part.update(grads, st, params)
            new_state.append(st)
        return grads, tuple(new_state)


@dataclasses.dataclass(frozen=True)
class ClientOptSpec:
    """Client-side optimizer config: name + hyperparameters."""

    name: str = "sgd"
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    persist: bool = False

    def transform(self) -> _Chain:
        parts = []
        if self.weight_decay:
            parts.append(_AddDecayedWeights(self.weight_decay))
        if self.name == "sgd":
            if self.momentum:
                parts.append(_Trace(self.momentum))
        elif self.name == "adam":
            parts.append(_ScaleByAdam(self.b1, self.b2, self.eps))
        else:
            raise ValueError(f"Unknown client optimizer {self.name!r}")
        return _Chain(parts)


@dataclasses.dataclass(frozen=True)
class ServerOptSpec:
    """Server-side optimizer config (reference default ``SGD(lr=0.1)``)."""

    name: str = "sgd"
    momentum: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def transform(self) -> _Chain:
        return ClientOptSpec(
            name=self.name, momentum=self.momentum, b1=self.b1, b2=self.b2,
            eps=self.eps, weight_decay=self.weight_decay,
        ).transform()


class RoundState(NamedTuple):
    """Everything that evolves across rounds, on the engine's device."""

    params: Params
    server_opt_state: Any
    client_opt_state: Any  # stacked [K, ...] with persist=True, else ()
    agg_state: Any
    attack_state: Any
    round_idx: int
    # the fault model's straggler buffer and fill; () without a fault model
    fault_state: Any = ()
    # the async server's buffer and per-client bookkeeping
    # (asyncfl/buffer.py:AsyncConfig.init_state); () for a sync engine
    async_state: Any = ()


class RoundMetrics(NamedTuple):
    train_loss: torch.Tensor  # scalar: mean loss over honest clients
    train_loss_all: torch.Tensor  # scalar: mean loss over all clients
    train_top1: torch.Tensor  # scalar: mean train top-1 over honest clients
    update_variance: torch.Tensor  # scalar: mean per-coord variance of updates
    update_variance_norm: torch.Tensor  # L2 norm of the per-coord variance
    agg_norm: torch.Tensor  # L2 norm of the aggregated update


class RoundInputs(NamedTuple):
    """A round's per-round scalars as 0-d tensors on the engine's device, in
    the eager and the captured round alike: a Python number would be baked
    into a CUDA graph as a constant. The host ``RoundState.round_idx`` stays
    the truth; ``round_t`` is its device copy, written at the round's entry
    (a fill, no host sync), for the sites that index by the round: the
    fault schedule's row, the async ring's slot, staleness and versions."""

    client_lr: torch.Tensor  # float32
    server_lr: torch.Tensor  # float32
    round_t: torch.Tensor  # int64


class RoundSpec(NamedTuple):
    """One round of a block: the seed and host round index its generators
    are rooted at, the round its batch is drawn for (``rng.DATA``), and its
    learning rates."""

    seed: int
    round_idx: int
    data_round: int
    client_lr: float
    server_lr: float


class TrainRequest(NamedTuple):
    """A round body's request for local training (``RoundEngine._serve``):
    every client of every chunk (``rows`` None) or the clients ``rows`` of
    one chunk (the streaming round; ``last`` on its final chunk, after
    which the batch is dropped). ``flat0``: the params flat; ``noise``:
    each local step's keep-masks for all K; ``lag``: the async round's
    ``(hist, slot)``, or None."""

    params: Params
    flat0: torch.Tensor
    opt_state: Any
    client_lr: torch.Tensor
    noise: list
    rows: Optional[slice] = None
    lag: Optional[tuple] = None
    last: bool = False


class RoundEngine:
    """Runs federated rounds and evaluation on one device.

    ``train_loss_fn``: ``(params, x, y, noise) -> (loss, {"top1": ...})``;
    ``eval_logits_fn``: ``(params, x) -> logits``; ``layout``: the params'
    flat order (``ModelSpec.layout``); ``noise_sites``: ``batch -> {name:
    (shape, keep)}``, the keep-masks ``train_loss_fn`` takes
    (``ModelSpec.noise_sites``; None for a model that draws nothing).

    ``client_chunks`` splits the K client axis into sequential chunks
    (``ops/streaming.py:chunk_layout``), each trained as one vmapped batch,
    so activation memory scales with the chunk, not with K; the masks are
    drawn for all K clients before the split, so a round does not depend on
    it. ``keep_updates`` keeps each round's post-attack ``[K, D]`` matrix as
    ``self.last_updates`` (under a fault model, the matrix the server
    received). ``fault_model``: a
    :class:`~blades_tpu_torch.faults.FaultModel` injecting dropout,
    straggler replays and payload corruption; each round's counters are
    then ``self.last_fault_diag`` (None without one, and the round is the
    same code path as before the fault model existed).

    ``streaming``: run the streaming round (module docstring), whose update
    memory is one ``[chunk_size, D]`` slab; ``keep_updates`` is then off.
    The build raises where a part has no streaming form: an aggregator
    without one (its ``streaming_optouts`` reason), an attack whose
    ``on_updates`` reads the whole population (``update_locality !=
    "row"``), a fault model with stragglers, ``collect_diagnostics`` (the
    forensics are defined on the dense matrix), an audit fallback without a
    streaming form; the audit monitor itself and the metric pack run in
    their streaming forms.

    ``collect_diagnostics``, ``audit_monitor`` (an
    :class:`~blades_tpu_torch.audit.AuditMonitor`) and ``round_metrics``:
    the round's forensics (module docstring, step 6), each round's in
    ``last_diagnostics`` / ``last_audit_diag`` / ``last_metric_pack`` (None
    when off); a block returns them stacked ``[R]``.

    ``remat``: rematerialize each client's clamped loss (module
    docstring); the results do not change.

    ``async_config``: an :class:`~blades_tpu_torch.asyncfl.AsyncConfig`;
    each round is then one buffered-asynchronous tick (module docstring),
    and its 10 counters are ``self.last_async_diag`` (0-d tensors).
    ``buffer_m`` is clamped into ``[1, K]`` (``self.async_buffer_m``). It
    needs an aggregator, and refuses ``streaming=True`` (the buffer is
    ``[K, D]`` state) and a fault model with stragglers (arrival staleness
    replaces their replay), as the JAX engine does.
    """

    def __init__(
        self,
        train_loss_fn: Callable,
        eval_logits_fn: Callable,
        params_template: Params,
        layout: FlatLayout,
        num_clients: int,
        num_byzantine: int = 0,
        attack: Optional[Attack] = None,
        aggregator: Optional[Aggregator] = None,
        client_opt: ClientOptSpec = ClientOptSpec(),
        server_opt: ServerOptSpec = ServerOptSpec(),
        num_classes: int = 10,
        loss_clamp: float = 1e6,
        trusted_mask: Optional[torch.Tensor] = None,
        client_chunks: int = 1,
        keep_updates: bool = True,
        device=None,
        noise_sites: Optional[Callable[[int], dict]] = None,
        fault_model: Optional[FaultModel] = None,
        streaming: bool = False,
        async_config=None,
        collect_diagnostics: bool = False,
        audit_monitor: Optional[AuditMonitor] = None,
        round_metrics: bool = False,
        remat: bool = False,
    ):
        if int(client_chunks) < 1:
            raise ValueError(f"client_chunks must be >= 1, got {client_chunks}")
        self.device = resolve_device(device)
        self.train_loss_fn = train_loss_fn
        self.eval_logits_fn = eval_logits_fn
        self.layout = layout
        self.noise_sites = noise_sites or (lambda batch: {})
        self.num_clients = int(num_clients)
        self.num_byzantine = int(num_byzantine)
        self.attack = attack or NoAttack()
        self.aggregator = aggregator
        self.client_opt = client_opt
        self.server_opt = server_opt
        self.num_classes = int(num_classes)
        self.loss_clamp = float(loss_clamp)
        self.client_chunks, self.chunk_size, self._pad = chunk_layout(
            self.num_clients, int(client_chunks)
        )
        self.streaming = bool(streaming)
        # a streaming round has no [K, D] matrix to keep
        self.keep_updates = bool(keep_updates) and not self.streaming
        self.last_updates: Optional[torch.Tensor] = None
        self.fault_model = fault_model
        self.last_fault_diag: Optional[dict] = None
        self.async_config = async_config
        self.last_async_diag: Optional[dict] = None
        self.async_buffer_m = 0
        self.collect_diagnostics = bool(collect_diagnostics)
        self.last_diagnostics: Optional[dict] = None
        self.audit_monitor = audit_monitor
        self.last_audit_diag: Optional[dict] = None
        self.round_metrics = bool(round_metrics)
        self.last_metric_pack = None
        # run_block: how the last block ran, and why not as a graph
        self.last_block_mode: Optional[str] = None
        self.last_block_reason: Optional[str] = None
        # core/graphs.py: the one captured round, replaced when the batch
        # source, the state layout or the fault model's program changes
        self.last_graph = None
        if async_config is not None:
            if self.streaming:
                raise ValueError(
                    "async_config is incompatible with streaming=True: the server buffer "
                    "is [K, D] state, the memory the streaming round exists to avoid"
                )
            if aggregator is None:
                raise ValueError("async_config requires an aggregator")
            if fault_model is not None and fault_model.has_stragglers:
                raise ValueError(
                    "async_config replaces the sync straggler-replay semantics with real "
                    "arrival staleness; configure the fault model without stragglers "
                    "(straggler_rate=0)"
                )
            # buffer slots are per client, so K bounds the first-M threshold
            self.async_buffer_m = max(1, min(int(async_config.buffer_m), self.num_clients))
        if self.streaming:
            self._validate_streaming()
        self.dim, self.unravel = make_unraveler(params_template, layout)
        # reference convention: the FIRST num_byzantine client ids are byzantine
        self.byz_mask = torch.arange(self.num_clients, device=self.device) < self.num_byzantine
        if trusted_mask is None:
            trusted_mask = torch.zeros(self.num_clients, dtype=torch.bool)
        self.trusted_mask = torch.as_tensor(trusted_mask, dtype=torch.bool).to(self.device)
        self._client_tx = client_opt.transform()
        self._server_tx = server_opt.transform()

        def clamped_loss(p, x, y, noise):
            loss, aux = self.train_loss_fn(p, x, y, noise)
            # parity: the reference clamps the loss to [0, 1e6] to survive
            # attack-induced blowups
            return torch.clamp(loss, 0.0, self.loss_clamp), aux

        self.remat = bool(remat)
        loss_fn = remat_fn(clamped_loss) if self.remat else clamped_loss
        # one client's (grads, (loss, aux)), mapped over the client axis
        self._grad_fn = vmap(grad_and_value(loss_fn, has_aux=True))
        self._ravel_rows = vmap(lambda p: ravel(p, self.layout))
        self._unravel_rows = vmap(self.unravel)

    def _validate_streaming(self) -> None:
        """Raise at build time where a configured part has no streaming form."""
        if self.aggregator is None or not self.aggregator.supports_streaming():
            raise ValueError(
                "streaming=True requires an aggregator" if self.aggregator is None
                else self.aggregator._no_streaming_msg()
            )
        if getattr(self.attack, "update_locality", "row") != "row":
            raise ValueError(
                f"streaming=True: attack {self.attack!r} rewrites updates from "
                f"full-population statistics (update_locality="
                f"{self.attack.update_locality!r}); the streaming round never "
                "holds the [K, D] matrix it needs"
            )
        if self.fault_model is not None and self.fault_model.has_stragglers:
            raise ValueError(
                "streaming=True: straggler replay buffers are [K, D] fault state; "
                "streaming supports participation/corruption faults only "
                "(straggler_rate=0)"
            )
        if self.collect_diagnostics:
            raise ValueError(
                "streaming=True cannot collect_diagnostics: aggregator forensics are "
                "defined on the dense [K, D] matrix"
            )
        fb = self.audit_monitor.fallback_aggregator if self.audit_monitor is not None else None
        if fb is not None and not fb.supports_streaming():
            raise ValueError("streaming=True: audit fallback " + fb._no_streaming_msg())

    @property
    def peak_update_bytes(self) -> int:
        """The largest update-matrix-shaped float32 buffer of a round: the
        ``[K, D]`` matrix, or one ``[chunk_size, D]`` slab when streaming
        (JAX counts the padded ``K``; the port's dense matrix has no
        padding)."""
        rows = self.chunk_size if self.streaming else self.num_clients
        return int(rows) * int(self.dim) * 4

    # -- state ---------------------------------------------------------------

    def init(self, params: Params) -> RoundState:
        # a private float32 copy on the engine's device: the round never
        # aliases the caller's tensors
        params = {
            n: t.detach().to(self.device, torch.float32).clone() for n, t in params.items()
        }
        # the defense's and the attack's initial state on the engine's
        # device: a round then copies nothing from the host (a captured one
        # could not)
        on_device = lambda tree: tree_map(  # noqa: E731
            lambda t: t.to(self.device) if isinstance(t, torch.Tensor) else t, tree)
        agg_state = (
            on_device(self.aggregator.init_state(self.num_clients, self.dim))
            if self.aggregator is not None
            else ()
        )
        client_opt_state = ()
        if self.client_opt.persist:
            # the stacked [K, ...] state of one client's init (JAX :487-493)
            k = self.num_clients
            client_opt_state = self._client_tx.init(
                {n: t.expand(k, *t.shape) for n, t in params.items()}, lead=(k,))
        return RoundState(
            params=params,
            server_opt_state=self._server_tx.init(params),
            client_opt_state=client_opt_state,
            agg_state=agg_state,
            attack_state=on_device(self.attack.init_state(self.num_clients, self.dim)),
            round_idx=0,
            fault_state=(
                self.fault_model.init_state(self.num_clients, self.dim, device=self.device)
                if self.fault_model is not None
                else ()
            ),
            async_state=(
                self.async_config.init_state(self.num_clients, self.dim, device=self.device)
                if self.async_config is not None
                else ()
            ),
        )

    # -- the round -------------------------------------------------------------

    def _chunk_rows(self):
        """The client rows of each chunk; the final chunk may be short."""
        k, cs = self.num_clients, self.chunk_size
        return [slice(lo, min(lo + cs, k)) for lo in range(0, k, cs)]

    def _draw_noise(self, noise_gen, steps: int, batch: int) -> list:
        """Every local step's keep-masks for all K clients, step after step
        from ``noise_gen``, so that no chunking changes which client gets
        which mask."""
        sites = self.noise_sites(batch)
        return [rng.keep_masks(sites, noise_gen, (self.num_clients,)) for _ in range(steps)]

    def _train_chunk(self, params, flat0, client_lr, cx, cy, rows, noise, opt_state=(),
                     start=None):
        """Local training of the clients ``rows`` (``_local_update`` with the
        chunk's client axis written out): ``(updates [n, D], losses [n],
        top1s [n], opt_state)``; ``noise`` holds each step's masks for all K;
        ``client_lr`` is a 0-d tensor. ``opt_state``: the chunk's rows of
        the persistent client state (``persist=True``), else ``()`` and each
        client starts from a fresh one. ``start``: the chunk's ``[n, D]``
        flat start params (the async round's version lag), else every
        client starts from ``params``. No host sync and no draw: the
        batched round (``core/batched.py``) maps it over experiments with
        ``torch.func.vmap``."""
        ids = torch.arange(self.num_clients, device=self.device)[rows]
        byz = self.byz_mask[rows]
        if start is None:
            p = {n: t.expand(ids.numel(), *t.shape) for n, t in params.items()}
        else:
            p, flat0 = self._unravel_rows(start), start
        if not self.client_opt.persist:
            opt_state = self._client_tx.init(p, lead=(ids.numel(),))
        losses, top1s = [], []
        for s, masks in enumerate(noise):
            x, y = self.attack.on_batch(
                cx[rows, s], cy[rows, s], byz, num_classes=self.num_classes, client_idx=ids,
            )
            grads, (loss, aux) = self._grad_fn(p, x, y, {n: m[rows] for n, m in masks.items()})
            grads = self.attack.on_grads(grads, byz, client_idx=ids)
            u, opt_state = self._client_tx.update(grads, opt_state, p)
            p = {n: p[n] - client_lr * u[n] for n in p}
            losses.append(loss)
            top1s.append(aux.get("top1", torch.full_like(loss, float("nan"))))
        over_steps = lambda xs: torch.stack(xs, 1).mean(1)  # noqa: E731
        return (self._ravel_rows(p) - flat0, over_steps(losses), over_steps(top1s),
                opt_state if self.client_opt.persist else ())

    def _train_clients(self, req: TrainRequest, batch):
        """Local training of all K clients, chunk by chunk: ``(updates [K,
        D], losses [K], top1s [K], client_opt_state)``, the last the
        chunks' new persistent rows concatenated (``()`` without
        ``persist``). ``batch``: the list ``[cx, cy]``, emptied once every
        chunk has trained, so that a batch nobody else holds is freed
        before the attack and the aggregation (``run_round_donated``).
        ``req.lag``: ``(hist [h, D], slot [K])``, each client's start params
        the ring row ``hist[slot]``, gathered per chunk (the async round);
        None trains every client from ``req.params``."""
        cx, cy = batch
        lag = req.lag
        out = []
        for rows in self._chunk_rows():
            opt = tree_map(lambda t: t[rows], req.opt_state)
            start = None if lag is None else lag[0][lag[1][rows]]
            out.append(self._train_chunk(req.params, req.flat0, req.client_lr, cx, cy, rows,
                                         req.noise, opt, start))
        del cx, cy
        batch.clear()
        updates, losses, top1s = (torch.cat(parts) for parts in list(zip(*out))[:3])
        return updates, losses, top1s, self._cat_opt_states([o[3] for o in out])

    def _cat_opt_states(self, states, dim: int = 0):
        """The chunks' persistent client states, concatenated along K."""
        if not self.client_opt.persist:
            return ()
        return tree_map(lambda *rows: torch.cat(rows, dim), *states)

    def _inputs(self, client_lr, server_lr, round_idx: int) -> RoundInputs:
        """The round's :class:`RoundInputs` on the engine's device: fills,
        no host-to-device copy."""
        def full(value, dtype):
            if isinstance(value, torch.Tensor):
                return value.to(self.device, dtype)
            return torch.full((), value, dtype=dtype, device=self.device)

        return RoundInputs(full(client_lr, torch.float32), full(server_lr, torch.float32),
                           full(int(round_idx), torch.int64))

    @torch.no_grad()
    def run_round(
        self,
        state: RoundState,
        cx: torch.Tensor,
        cy: torch.Tensor,
        client_lr: float,
        server_lr: float,
        seed: int = 0,
    ) -> Tuple[RoundState, RoundMetrics]:
        """One federated round. ``cx``/``cy``: ``[K, S, B, ...]`` on the
        engine's device. ``seed`` roots the round's dropout, attack and
        aggregator generators (``utils/rng.py``)."""
        return self.run_round_donated(state, [cx, cy], client_lr, server_lr, seed)

    @torch.no_grad()
    def run_round_donated(
        self, state: RoundState, batch: list, client_lr: float, server_lr: float,
        seed: int = 0,
    ) -> Tuple[RoundState, RoundMetrics]:
        """:meth:`run_round` on ``batch``, the list ``[cx, cy]``, which the
        round empties once local training has consumed it: when the caller
        keeps no other reference (``Simulator.run`` keeps none),
        the caching allocator reuses the batch's memory during the attack
        and the aggregation (the JAX package donates the buffers to its
        round program, ``blades_tpu/core/engine.py:245-251``). The results
        do not change."""
        self._check_runnable()
        streams = rng.RoundStreams(seed, state.round_idx, self.device)
        # the dispatch accounting's window (telemetry/timeline.py): the
        # caller closes it after its own wait on the card
        timeline.launch_begin("round", rounds=1, attrs=self._timeline_attrs())
        with get_recorder().span("dispatch"):
            out = self._round(state, batch,
                              self._inputs(client_lr, server_lr, state.round_idx), streams)
        timeline.launch_enqueued()
        return out

    def _timeline_attrs(self) -> dict:
        """The static labels of this engine's ``timeline`` records: which
        round semantics its launches run."""
        return {"streaming": int(self.streaming), "async": int(self.async_config is not None)}

    def _check_runnable(self) -> None:
        if self.aggregator is None:
            raise ValueError("RoundEngine.run_round needs an aggregator")

    def _round(self, state, batch, inputs: RoundInputs, streams: rng.RoundStreams):
        """The round body shared by the eager and the captured round: the
        async tick, the streaming round or the dense round, each drawing
        from ``streams`` and reading its scalars from ``inputs``."""
        cx = batch[0]
        body = self._round_body(state, inputs, streams, (cx.shape[1], cx.shape[2]))
        box = None
        try:
            while True:
                kind, req = body.send(box)
                box = [self._serve(kind, req, batch)]
                del req  # the body alone holds what it handed over (the pre-attack matrix)
        except StopIteration as stop:
            return stop.value

    def _round_body(self, state, inputs, streams, steps_batch):
        """The round as a generator (``core/batched.py`` drives S of them in
        lockstep): it yields ``(kind, request)`` where it trains
        (``"train"``, a :class:`TrainRequest`), rewrites the updates
        (``"attack"``), aggregates (``"aggregate"``) and steps the server
        (``"server"``), is sent what :meth:`_serve` answers in a one-item
        list that it empties (so the driver keeps no reference to a matrix
        the body goes on to replace), and returns
        ``(new state, metrics)``. ``steps_batch``: the batch's local steps and
        batch size, for the keep-masks."""
        if self.async_config is not None:
            from blades_tpu_torch.asyncfl.engine import async_round

            return async_round(self, state, inputs, streams, steps_batch)
        if self.streaming:
            return self._round_streaming(state, inputs, streams, steps_batch)
        return self._round_dense(state, inputs, streams, steps_batch)

    def _serve(self, kind, req, batch):
        """One experiment's answer to a round body's request."""
        if kind == "train":
            if req.rows is None:
                return self._train_clients(req, batch)
            out = self._train_chunk(req.params, req.flat0, req.client_lr, batch[0], batch[1],
                                    req.rows, req.noise, req.opt_state)
            if req.last:
                batch.clear()
            return out
        if kind == "attack":
            updates, byz, generator, attack_state = req
            return self.attack.on_updates(updates, byz, generator, attack_state)
        if kind == "aggregate":
            updates, agg_state, mask, ctx = req
            if self.collect_diagnostics:
                return self.aggregator.aggregate_masked_with_diagnostics(
                    updates, agg_state, mask=mask, **ctx)
            return (*self.aggregator.aggregate_masked(updates, agg_state, mask=mask, **ctx), None)
        if kind == "server":
            return self._server_step(*req)
        raise ValueError(f"unknown round request {kind!r}")

    def _round_dense(self, state, inputs, streams, steps_batch):
        """The dense round (module docstring, steps 1-6), as a round body."""
        flat0 = ravel(state.params, self.layout)
        updates, losses, top1s, client_opt_state = (yield "train", TrainRequest(
            state.params, flat0, state.client_opt_state, inputs.client_lr,
            self._draw_noise(streams(rng.DROPOUT), *steps_batch))).pop()

        # parity: the reference nan_to_num's every uploaded update
        updates = torch.nan_to_num(updates)
        updates, attack_state = (yield "attack", (
            updates, self.byz_mask, streams(rng.ATTACK), state.attack_state)).pop()
        # the variance metrics stay on the matrix the clients sent
        sent_updates = updates
        fault_state, part_mask, fault_diag = state.fault_state, None, None
        if self.fault_model is not None:
            updates, part_mask, fault_state, fault_diag = self.fault_model.apply(
                updates, state.fault_state, streams(rng.FAULT), inputs.round_t,
            )
        agg_ctx = dict(
            trusted_mask=self.trusted_mask,
            params_flat=flat0,
            generator=streams(rng.AGG),
        )
        # mask None: the unmasked aggregate (the trimmed mean's kernel)
        agg, agg_state, agg_diag = (yield "aggregate", (updates, state.agg_state, part_mask,
                                                       agg_ctx)).pop()
        if part_mask is not None:
            # a round with no participant applies the zero update
            agg = torch.where(part_mask.any(), agg, torch.zeros_like(agg))
        agg, audit_diag, metric_pack = self._audit_and_pack(
            updates, agg, part_mask, self._fallback_ctx(agg_ctx, streams))

        # population variance (ddof 0), as jnp.var: torch.var defaults to ddof 1
        var = sent_updates.var(dim=0, correction=0)
        self.last_updates = updates if self.keep_updates else None
        self.last_fault_diag = fault_diag
        self.last_diagnostics = agg_diag
        self.last_audit_diag = audit_diag
        self.last_metric_pack = metric_pack
        return (yield from self._finish_round(
            state, inputs.server_lr, agg, agg_state, attack_state, fault_state, losses, top1s,
            var, client_opt_state))

    def _fallback_ctx(self, agg_ctx: dict, streams: rng.RoundStreams) -> dict:
        """The audit fallback's aggregation context: the round's, with a
        copy of the ``AGG`` generator at the stream's entry state. The JAX
        package hands the defense and the fallback one key
        (``blades_tpu/core/engine.py:763-769``, ``:804-808``), so a random
        fallback draws what the defense drew, not what follows it."""
        audit = self.audit_monitor
        if audit is None or audit.fallback_aggregator is None:
            return agg_ctx
        return dict(agg_ctx, generator=streams(rng.AGG, copy=1))

    def _audit_and_pack(self, updates, agg, mask, agg_ctx):
        """The audit monitor's certificates and fallback on ``agg`` (its
        fallback gets ``agg_ctx``, from :meth:`_fallback_ctx`), then the metric pack
        of ``updates`` against the aggregate applied: ``(applied aggregate,
        audit diag or None, pack or None)``. ``mask`` None: every row."""
        audit_diag = metric_pack = None
        if self.audit_monitor is not None:
            agg, audit_diag = self.audit_monitor.apply(
                updates, agg, mask=mask, byz_mask=self.byz_mask, **agg_ctx)
        if self.round_metrics:
            if mask is None:
                mask = torch.ones(self.num_clients, dtype=torch.bool, device=self.device)
            metric_pack = pack_dense(updates, mask, self.byz_mask, agg, self.client_chunks,
                                     self.chunk_size)
        return agg, audit_diag, metric_pack

    def _round_streaming(self, state, inputs, streams, steps_batch):
        """The streaming round (module docstring), as a round body: one
        ``[chunk_size, D]`` slab at a time, in the JAX chunk body's order.
        Counts stay device tensors; the chunk loop itself is a host loop.
        The batch is dropped once the last chunk has trained."""
        k, dev = self.num_clients, self.device
        fm = self.fault_model

        def padded(mask):  # a [K] mask, False on the final chunk's padding
            return torch.cat([mask, mask.new_zeros(self._pad)])

        valid = padded(torch.ones(k, dtype=torch.bool, device=dev))
        byz = padded(self.byz_mask)
        part0, corrupt, fill, fault_diag = valid, None, None, None
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        n_part, n_excl, n_dropped = zero, zero, zero
        if fm is not None:
            # the [K] decisions, from the draws the dense round takes
            part0, drop, corrupt = fm.plan_streaming(k, streams(rng.FAULT), inputs.round_t)
            part0, corrupt = padded(part0), padded(corrupt)
            if fm.value_corruption:
                fill = state.fault_state["fill"]
            n_dropped = drop.to(torch.int32).sum(dtype=torch.int32)

        flat0 = ravel(state.params, self.layout)
        sctx = dict(params_flat=flat0, generator=streams(rng.AGG))
        agg_ss = self.aggregator.streaming_init(
            k, self.client_chunks, self.chunk_size, self.dim, state.agg_state, device=dev)
        audit = self.audit_monitor
        fb = audit.fallback_aggregator if audit is not None else None
        layout = (k, self.client_chunks, self.chunk_size, self.dim)
        fb_ss = fb.streaming_init(*layout, (), device=dev) if fb is not None else None
        fb_ctx = self._fallback_ctx(sctx, streams)
        aud_ss = audit.streaming_init(*layout, device=dev) if audit is not None else None
        mp = pack_init(self.client_chunks, self.dim, device=dev) if self.round_metrics else None
        mp_norms, mp_masks = [], []
        noise = self._draw_noise(streams(rng.DROPOUT), *steps_batch)
        mom = moments_init(self.dim, device=dev)
        attack_state, losses, top1s, opt_states = state.attack_state, [], [], []
        chunks = self._chunk_rows()
        for j, rows in enumerate(chunks):
            upd, loss, top1, opt = (yield "train", TrainRequest(
                state.params, flat0, tree_map(lambda t: t[rows], state.client_opt_state),
                inputs.client_lr, noise, rows=rows, last=j == len(chunks) - 1)).pop()
            losses.append(loss)
            top1s.append(top1)
            opt_states.append(opt)
            if upd.shape[0] < self.chunk_size:  # the final chunk's padding: zero rows
                upd = torch.cat([upd, upd.new_zeros(self.chunk_size - upd.shape[0], self.dim)])
            sl = slice(j * self.chunk_size, (j + 1) * self.chunk_size)
            upd = torch.nan_to_num(upd)
            upd, attack_state = (yield "attack", (
                upd, byz[sl], streams(rng.ATTACK, chunk=j), attack_state)).pop()
            # the variance metrics stay on what the clients sent
            mom = moments_update(mom, upd, valid[sl])
            part = valid[sl]
            if fm is not None:
                upd = fm.corrupt_chunk(
                    upd, corrupt[sl], streams(rng.FAULT, chunk=j), fill=fill)
                part = part0[sl]
                if fm.guard_nonfinite:
                    finite = torch.isfinite(upd).all(dim=1)
                    n_excl = n_excl + (part & ~finite).to(torch.int32).sum(dtype=torch.int32)
                    part = part & finite
            mask, safe = Aggregator._sanitize(upd, part)
            del upd
            n_part = n_part + mask.to(torch.int32).sum(dtype=torch.int32)
            agg_ss = self.aggregator.streaming_update(agg_ss, safe, chunk_mask=mask,
                                                      chunk_index=j, **sctx)
            if fb is not None:
                fb_ss = fb.streaming_update(fb_ss, safe, chunk_mask=mask, chunk_index=j,
                                            **fb_ctx)
            if audit is not None:
                aud_ss = audit.streaming_update(aud_ss, safe, chunk_mask=mask, chunk_index=j)
            if mp is not None:
                # the same sanitized slab and mask the defense consumed
                mp, norms = pack_update(mp, safe, mask, byz[sl], j)
                mp_norms.append(norms)
                mp_masks.append(mask)
            del safe
        del noise
        agg, agg_state = self.aggregator.streaming_finalize(agg_ss, state.agg_state, **sctx)
        # a round with no participant applies the zero update
        agg = torch.where(n_part > 0, agg, torch.zeros_like(agg))
        audit_diag = metric_pack = None
        if audit is not None:
            fb_agg = None
            if fb is not None:
                fb_agg, _ = fb.streaming_finalize(fb_ss, (), **fb_ctx)
                fb_agg = torch.where(n_part > 0, fb_agg, torch.zeros_like(fb_agg))
            agg, audit_diag = audit.streaming_apply(aud_ss, agg, fallback_agg=fb_agg)
        if mp is not None:
            # closed against the aggregate applied, as the dense round's
            metric_pack = pack_finalize(mp, torch.cat(mp_norms)[:k], torch.cat(mp_masks)[:k],
                                        agg)
        if fm is not None:
            fault_diag = {
                "participants": n_part, "dropped": n_dropped,
                "stale_replayed": zero, "stragglers_expired": zero,
                "corrupted": corrupt.to(torch.int32).sum(dtype=torch.int32),
                "excluded_nonfinite": n_excl,
            }
        self.last_updates = None
        self.last_fault_diag = fault_diag
        self.last_diagnostics = None
        self.last_audit_diag = audit_diag
        self.last_metric_pack = metric_pack
        return (yield from self._finish_round(
            state, inputs.server_lr, agg, agg_state, attack_state, state.fault_state,
            torch.cat(losses), torch.cat(top1s), moments_var(mom),
            self._cat_opt_states(opt_states)))

    def _server_step(self, params, server_opt_state, server_lr, agg):
        """``(params, server_opt_state)`` after the server step with ``agg``
        as pseudo-gradient (``grad := -agg``)."""
        server_updates, server_opt_state = self._server_tx.update(
            self.unravel(-agg), server_opt_state, params
        )
        params = {n: p - server_lr * server_updates[n] for n, p in params.items()}
        return params, server_opt_state

    def _metrics(self, losses, top1s, var, agg) -> RoundMetrics:
        honest = (~self.byz_mask).to(losses.dtype)
        n_honest = torch.clamp_min(honest.sum(), 1.0)
        return RoundMetrics(
            train_loss=(losses * honest).sum() / n_honest,
            train_loss_all=losses.mean(),
            train_top1=(top1s * honest).sum() / n_honest,
            update_variance=var.mean(),
            update_variance_norm=torch.linalg.vector_norm(var),
            agg_norm=torch.linalg.vector_norm(agg),
        )

    def _finish_round(self, state, server_lr, agg, agg_state, attack_state, fault_state,
                      losses, top1s, var, client_opt_state):
        """The server step (a round body's ``"server"`` request), the round's
        metrics, and the next state."""
        params, server_opt_state = (yield "server", (state.params, state.server_opt_state,
                                                    server_lr, agg)).pop()
        new_state = RoundState(
            params=params,
            server_opt_state=server_opt_state,
            client_opt_state=client_opt_state,
            agg_state=agg_state,
            attack_state=attack_state,
            round_idx=state.round_idx + 1,
            fault_state=fault_state,
        )
        return new_state, self._metrics(losses, top1s, var, agg)

    # -- round blocks ----------------------------------------------------------

    def graph_block_reason(self) -> Optional[str]:
        """None when this engine's blocks are captured as a CUDA graph
        (``core/graphs.py``), else why they run eagerly. Decided from the
        configuration at build time, never by trying a capture: a capture
        that fails on a configuration this calls graph-safe raises."""
        if self.device.type != "cuda":
            return f"the engine runs on {self.device}; a CUDA graph needs the card"
        if self.streaming:
            return ("the streaming round draws from per-chunk generators, not yet "
                    "registered with a graph (ROADMAP.md queue B, item 7c)")
        parts = [self.attack, self.aggregator]
        if self.audit_monitor is not None and self.audit_monitor.fallback_aggregator is not None:
            parts.append(self.audit_monitor.fallback_aggregator)  # runs every round
        for part in parts:
            if part.graph_unsafe_reason:
                return f"{part!r}: {part.graph_unsafe_reason}"
        return None

    @torch.no_grad()
    def run_block(
        self,
        state: RoundState,
        rounds,
        client_lrs,
        server_lrs,
        seed: int = 0,
        sampler: Optional[Callable] = None,
    ):
        """``R = len(rounds)`` federated rounds with the dataset's sampler
        fused in (``sampler``: ``generator -> (cx, cy)``,
        ``FLDataset.sampler``): round ``i`` draws its batch from the
        ``DATA`` generator of round ``rounds[i]`` (the rounds
        ``sample_round`` would be called for), and its other generators
        are rooted at ``state.round_idx + i``. ``client_lrs`` /
        ``server_lrs``: ``[R]`` schedules.

        On a CUDA engine whose configuration is graph-safe
        (:meth:`graph_block_reason`) the block replays one captured round R
        times (``core/graphs.py``; the first block of a new capture runs its
        first round eagerly as the warm-up), with no host sync; otherwise it
        runs the R rounds eagerly. ``self.last_block_mode`` (``"graph"`` or
        ``"eager"``) and ``self.last_block_reason`` say which and why. Either
        way the block equals R sequential :meth:`run_round` calls bit for
        bit (JAX contract, ``blades_tpu/core/engine.py:1230-1234``).

        Returns ``(new_state, metrics, diags)``: :class:`RoundMetrics` of
        ``[R]`` tensors, and the JAX package's ``diags`` dict, whose
        ``defense``, ``faults``, ``audit``, ``metrics`` and ``async`` hold
        each round's diagnostics, fault counters, audit fields, metric pack
        and async counters stacked ``[R]`` (None where that surface is
        off; JAX ``:1229-1271``). ``last_updates`` is None after a block;
        the other ``last_*`` hold its final round's."""
        if sampler is None:
            raise ValueError("run_block needs the dataset's sampler (FLDataset.sampler)")
        rounds = [int(r) for r in rounds]
        if not len(client_lrs) == len(server_lrs) == len(rounds) > 0:
            raise ValueError(
                f"run_block needs one learning rate of each kind per round: {len(rounds)} "
                f"rounds, {len(client_lrs)} client and {len(server_lrs)} server rates"
            )
        specs = [RoundSpec(int(seed), state.round_idx + i, r, float(c), float(s))
                 for i, (r, c, s) in enumerate(zip(rounds, client_lrs, server_lrs))]
        timeline.launch_begin("block", rounds=len(specs), attrs=self._timeline_attrs())
        with get_recorder().span("dispatch", rounds=len(specs)):
            state, outs = self._run_rounds(state, specs, sampler=sampler)
        timeline.launch_enqueued()
        return state, outs[0], block_diags(outs)

    def round_outputs(self, metrics) -> tuple:
        """A round's outputs as a block stacks them: its metrics, then the
        ``last_*`` surfaces in :data:`BLOCK_DIAGS` order (None where off)."""
        return (metrics, self.last_diagnostics, self.last_fault_diag, self.last_audit_diag,
                self.last_metric_pack, self.last_async_diag)

    def _run_rounds(self, state, specs, sampler=None, batches=None):
        """The rounds of ``specs`` in order, each on a batch from ``sampler``
        or on its own ``batches[i]`` (``(cx, cy)``): captured and replayed
        where :meth:`graph_block_reason` allows, else eagerly. Returns the
        new state and the rounds' :meth:`round_outputs`, each stacked
        ``[R]`` (None where the surface is off), and sets
        ``last_block_mode`` / ``last_block_reason`` and the ``last_*``
        surfaces to the final round's."""
        self._check_runnable()
        reason = self.graph_block_reason()
        if reason is None:
            from blades_tpu_torch.core.graphs import run_graph

            state, outs = run_graph(self, state, specs, sampler=sampler, batches=batches)
        else:
            state, outs = self._run_eager(state, specs, sampler, batches)
        self.last_block_mode = "graph" if reason is None else "eager"
        self.last_block_reason = reason
        last = lambda tree: None if tree is None else tree_map(lambda a: a[-1], tree)  # noqa: E731
        self.last_updates = None
        (self.last_diagnostics, self.last_fault_diag, self.last_audit_diag,
         self.last_metric_pack, self.last_async_diag) = (last(t) for t in outs[1:])
        return state, outs

    def _run_eager(self, state, specs, sampler, batches):
        """:meth:`_run_rounds` round by round, each as :meth:`run_round`
        runs it; the outputs are stacked on the device, so the block itself
        waits for nothing (a defense that tests a stopping rule on the host
        still does, inside its round)."""
        outs = []
        for i, spec in enumerate(specs):
            streams = rng.RoundStreams(spec.seed, spec.round_idx, self.device,
                                       data_round=spec.data_round)
            batch = list(sampler(streams(rng.DATA)) if batches is None else batches[i])
            state, metrics = self._round(
                state, batch, self._inputs(spec.client_lr, spec.server_lr, spec.round_idx),
                streams)
            outs.append(self.round_outputs(metrics))
        stack = lambda *xs: None if xs[0] is None else torch.stack(xs)  # noqa: E731
        return state, tree_map(stack, *outs)

    # -- evaluation ----------------------------------------------------------

    @torch.no_grad()
    def evaluate_per_sample(
        self, state: RoundState, x: torch.Tensor, y: torch.Tensor, batch_size: int = 512
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-sample test loss and correctness (numpy ``[N]`` arrays)."""
        losses, correct = [], []
        for beg in range(0, x.shape[0], batch_size):
            logits = self.eval_logits_fn(state.params, x[beg : beg + batch_size])
            yb = y[beg : beg + batch_size].long()
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            losses.append(-logp.gather(-1, yb[:, None])[:, 0])
            correct.append((logits.argmax(dim=-1) == yb).to(torch.float32))
        return torch.cat(losses).cpu().numpy(), torch.cat(correct).cpu().numpy()


#: the keys of a block's ``diags``, in :meth:`RoundEngine.round_outputs`
#: order after the metrics
BLOCK_DIAGS = ("defense", "faults", "audit", "metrics", "async")


def block_diags(outs) -> dict:
    """A block's stacked :meth:`RoundEngine.round_outputs` as the JAX
    package's ``diags`` dict."""
    return dict(zip(BLOCK_DIAGS, outs[1:]))


_HOST_DTYPES = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32,
                torch.int64: np.int64, torch.bool: np.bool_}


def outputs_to_host(tree):
    """``tree`` with every tensor leaf as a numpy array of its dtype, read
    from the device in ONE copy: the leaves travel as one float64 vector
    (exact for float32, bool and the int32 counters), so a round's or a
    block's metrics and forensics cost one host sync together."""
    leaves, spec = tree_flatten(tree)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    if not tensors:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            n = leaf.numel()
            leaf = flat[at:at + n].reshape(tuple(leaf.shape)).astype(_HOST_DTYPES[leaf.dtype])
            at += n
        out.append(leaf)
    return tree_unflatten(out, spec)


def multistep_lr(lr0: float, milestones=(), gamma: float = 0.5) -> Callable[[int], float]:
    """torch ``MultiStepLR`` parity: lr decays by ``gamma`` at each milestone
    round; a host-side float function of the round index."""

    def lr(round_idx: int) -> float:
        return lr0 * (gamma ** sum(1 for m in milestones if round_idx >= m))

    return lr
