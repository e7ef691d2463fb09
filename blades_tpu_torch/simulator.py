"""Simulator: the public orchestrator, reference-API compatible.

Counterpart: ``blades_tpu/simulator.py`` — the constructor
(:152-242, with the strict unknown-kwarg error and the ALIE and label
flipping auto-fills at :194-198), ``run`` for the per-round synchronous
dense loop (:297-1046: model spec, ``engine.init``, ``sample_round`` ->
``run_round`` -> ``log_train`` / ``log_variance``, periodic ``evaluate``;
``fault_model`` as a ``FaultModel`` or its kwargs, :466-467;
``async_config`` as an ``AsyncConfig`` or its kwargs, :470-471;
``streaming`` and its guard against ``retain_updates`` / ``on_round_end``,
:475-479), ``_CompositeAttack`` (:69-148) and ``register_attackers``
(:262-275, wired in at :597-598), the stats records (:1240-1260) and
``evaluate`` (:1396-1437); round blocks (``block_size``, :788-846, and
``_run_blocks``, :1048-1192), ``donate_batches`` and the engine cache's key
(``engine_cache``, :640-715); checkpoints, the crash autosave and resume
(:748-780, :936-1000). It writes the same ``stats`` records
(``train``, ``variance``, ``client_validation``, ``test``) with the same
keys, a block's rounds included.

The telemetry trace (:461-465, :523-552, :869-960, :1096-1182,
:1262-1395): every run writes ``<log_path>/telemetry.jsonl`` (a fresh run
starts it anew, a resumed or supervised one appends, :511-522): the
``meta`` record, the span tree ``round`` / ``sample`` / ``dispatch`` /
``sync`` / ``eval`` / ``checkpoint`` (``block`` in a block), one ``round``
record per round, and the round's ``defense``, ``faults``, ``audit``,
``metrics`` and ``async`` records where those surfaces are on
(``collect_diagnostics``, ``fault_model``, ``audit_monitor``,
``round_metrics``, ``async_config``), with their gauges, counters and
byzantine-overlap summaries. ``BLADES_TELEMETRY=0`` turns it off.

The run's own records (:511, :557-570, :829, :893, :951-964, :1010-1026,
:1111): one ``timeline`` record per round (or block) from the dispatch
accounting (``telemetry/timeline.py``), closed at the round's existing
``sync`` and emitted at its existing flush; the alert engine
(``telemetry/alerts.py``) watching the trace's records; a ``started``
and one terminal (``finished`` / ``crashed`` / ``killed``) record in the
run ledger (``telemetry/ledger.py``, the path in ``BLADES_LEDGER``); and a
heartbeat beat at each flush (``supervision/heartbeat.py``, when
``BLADES_HEARTBEAT_FILE`` is set). ``BLADES_RESUME=1`` resumes. Under a
run supervisor (``BLADES_SUPERVISED=1``, ``supervision/supervisor.py``)
SIGTERM becomes :class:`SupervisorTermination` in the round loop (:61,
:728-745), so the crash autosave fires before the supervisor's SIGKILL.

``device=None`` runs on the GPU and raises where CUDA is unavailable; pass
``device="cpu"`` to run on the CPU. Options that select a path not ported
yet raise ``NotImplementedError`` naming the ``ROADMAP.md`` slice (queue A)
that brings it.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils._pytree import tree_map

from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.asyncfl import AsyncConfig
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.attackers.base import Attack
from blades_tpu_torch.audit import AuditMonitor
from blades_tpu_torch.client import BladesClient, ByzantineClient
from blades_tpu_torch.core.engine import (
    BLOCK_DIAGS,
    ClientOptSpec,
    RoundEngine,
    ServerOptSpec,
    multistep_lr,
    outputs_to_host,
    resolve_device,
)
from blades_tpu_torch.datasets.base import BaseDataset
from blades_tpu_torch.datasets.fl import FLDataset
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.models import create_model
from blades_tpu_torch.models.common import ModelSpec, build_fns
from blades_tpu_torch.server import BladesServer
from blades_tpu_torch.supervision import heartbeat
from blades_tpu_torch.sweeps import (
    config_fingerprint,
    contains_callables,
    program_fingerprint,
    static_fingerprint,
)
from blades_tpu_torch.telemetry import NULL_RECORDER, Recorder, context, set_recorder
from blades_tpu_torch.telemetry import alerts, ledger, profiling, timeline
from blades_tpu_torch.telemetry.metric_pack import pack_to_fields
from blades_tpu_torch.utils import rng
from blades_tpu_torch.utils.checkpoint import (
    RESUME_ENV,
    checkpoint_file,
    restore_state,
    save_state,
)
from blades_tpu_torch.utils.logging import initialize_logger
from blades_tpu_torch.utils.metrics import top1_accuracy

_IGNORED_KWARGS = ("num_actors", "num_trainers", "gpu_per_actor", "mode", "use_cuda")


class SupervisorTermination(BaseException):
    """Raised in the round loop when the run supervisor SIGTERMs a
    supervised run (``BLADES_SUPERVISED=1``; ``blades_tpu/simulator.py:61``).
    A ``BaseException``, like ``KeyboardInterrupt``: an ``except Exception``
    cannot swallow the shutdown, and the run's crash autosave still fires
    before the process dies."""


def _install_sigterm():
    """Under a supervisor, on the main thread: turn SIGTERM into
    :class:`SupervisorTermination` in the round loop. Returns the previous
    handler to restore, or None when nothing was installed."""
    if (os.environ.get(heartbeat.SUPERVISED_ENV) != "1"
            or threading.current_thread() is not threading.main_thread()):
        return None

    def _on_sigterm(signum, frame):
        raise SupervisorTermination("SIGTERM from run supervisor")

    try:
        return signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        return None


def _torch_dtype(name) -> Optional[torch.dtype]:
    """``None``, a ``torch.dtype`` or its name (``"bfloat16"``) as a float
    ``torch.dtype``."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {name!r} is not a float dtype")
    return dtype


def _unported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to blades_tpu_torch yet (ROADMAP.md queue A, "
        f"{slice_name})"
    )


class _CompositeAttack(Attack):
    """Each registered attacker's hooks on its own rows (``blades_tpu/
    simulator.py:69-148``), as the reference runs each client object's own
    hooks: ``on_batch`` and ``on_grads`` dispatch per row through a ``[K]``
    client -> branch table (branch 0 is honest; each distinct dishonest
    attack has a branch), by a ``torch.where`` per branch where the JAX
    package takes ``lax.switch`` per client; ``on_updates`` gives every
    attacker's ``omniscient_callback`` the pre-attack matrix and the full
    byzantine mask, and keeps only that attacker's row of its output.

    Every callback draws from the same stream, as every JAX callback gets
    the same key: each gets a generator at the state the round's generator
    had on entry, so two noise attackers draw the same normals. In the
    streaming round ``on_updates`` sees one chunk's slab and its mask, and
    an attacker's client index then names a row of the slab (dropped past
    its end), as in the JAX streaming round."""

    graph_unsafe_reason = ("each callback's generator is set to the round's entry state "
                           "inside the round (rng.clone) (ROADMAP.md queue B, item 7c)")

    def __init__(self, entries):
        # entries: [(client index, ByzantineClient)]; attacks built once
        self.entries = entries
        self._attacks = [c.make_attack() for _, c in entries]
        self.trains_dishonestly = any(
            a is not None and a.trains_dishonestly for a in self._attacks)
        self._branches, branch_of, self._idx_to_branch = [], {}, {}
        for (idx, _), a in zip(entries, self._attacks):
            if a is None or not a.trains_dishonestly:
                continue
            if id(a) not in branch_of:
                self._branches.append(a)
                branch_of[id(a)] = len(self._branches)
            self._idx_to_branch[idx] = branch_of[id(a)]
        self._branch_table = None

    def init_state(self, num_clients, dim):
        # the [K] branch table, now that K is known
        table = torch.zeros(num_clients, dtype=torch.int32)
        for idx, b in self._idx_to_branch.items():
            table[idx] = b
        self._branch_table = table
        return tuple(a.init_state(num_clients, dim) if a is not None else ()
                     for a in self._attacks)

    def _rows(self, client_idx):
        """Each row's branch, on the rows' device."""
        if self._branch_table.device != client_idx.device:
            self._branch_table = self._branch_table.to(client_idx.device)
        return self._branch_table[client_idx]

    @staticmethod
    def _pick(sel, new, old):
        return torch.where(sel.view(-1, *([1] * (old.dim() - 1))), new, old)

    def on_batch(self, x, y, byz_mask, *, num_classes, generator=None, client_idx=None):
        if not self._branches or client_idx is None:
            return x, y
        branch = self._rows(client_idx)
        out_x, out_y = x, y
        for b, a in enumerate(self._branches, 1):
            bx, by = a.on_batch(x, y, byz_mask, num_classes=num_classes, generator=generator,
                                client_idx=client_idx)
            sel = branch == b
            out_x, out_y = self._pick(sel, bx, out_x), self._pick(sel, by, out_y)
        return out_x, out_y

    def on_grads(self, grads, byz_mask, client_idx=None):
        if not self._branches or client_idx is None:
            return grads
        branch = self._rows(client_idx)
        out = grads
        for b, a in enumerate(self._branches, 1):
            bg = a.on_grads(grads, byz_mask, client_idx=client_idx)
            sel = branch == b
            out = {n: self._pick(sel, bg[n], g) for n, g in out.items()}
        return out

    def on_updates(self, updates, byz_mask, generator=None, state=()):
        pre, out, new_states = updates, updates, []
        for (idx, client), st in zip(self.entries, state):
            rewritten, st = client.omniscient_callback(pre, byz_mask, rng.clone(generator), st)
            if idx < out.shape[0]:
                out = out.clone() if out is pre else out
                out[idx] = rewritten[idx]
            new_states.append(st)
        return out, tuple(new_states)


class Simulator:
    def __init__(
        self,
        dataset: Union[BaseDataset, FLDataset],
        num_byzantine: Optional[int] = 0,
        attack: Optional[str] = None,
        attack_kws: Optional[Dict] = None,
        aggregator: Union[str, Callable] = "mean",
        aggregator_kws: Optional[Dict] = None,
        log_path: str = "./outputs",
        metrics: Optional[dict] = None,
        seed: Optional[int] = None,
        mesh_shape: Optional[tuple] = None,
        num_actors: Optional[int] = 1,
        num_trainers: Optional[int] = 1,
        gpu_per_actor: Optional[float] = 0,
        mode: Optional[str] = "actor",
        use_cuda: Optional[bool] = False,
        device=None,
        **kwargs,
    ):
        if kwargs:
            # parity: strict unknown-kwarg error
            unknown = ", ".join(kwargs)
            raise RuntimeError(f"Unknown keyword argument(s): {unknown}")
        if mesh_shape is not None:
            raise _unported("mesh_shape (sharding over devices)", "slice 12 (parallel)")
        # first: a run asked of the GPU must not start anything on the CPU
        self.device = resolve_device(device)

        self.aggregator = get_aggregator(aggregator, **(aggregator_kws or {}))

        if isinstance(dataset, FLDataset):
            self.dataset = dataset.to(self.device)
            self._num_classes = int(dataset.test_y.max()) + 1
            self._train_bs = 32
        else:
            self.dataset = dataset.get_dls(self.device)
            self._num_classes = dataset.num_classes
            self._train_bs = dataset.train_bs

        self.seed = 0 if seed is None else int(seed)
        self.num_byzantine = int(num_byzantine) if attack is not None else 0

        # auto-filled population hyperparameters the reference makes callers
        # pass by hand (ALIE's num_clients / num_byzantine, label flipping's
        # num_classes)
        attack_kws = dict(attack_kws or {})
        k = self.dataset.num_clients
        if attack == "alie":
            attack_kws.setdefault("num_clients", k)
            attack_kws.setdefault("num_byzantine", self.num_byzantine)
        if attack == "labelflipping":
            attack_kws.setdefault("num_classes", self._num_classes)
        self.attack = get_attack(attack, **attack_kws)

        initialize_logger(log_path)
        self.log_path = log_path
        self.metrics = {"top1": top1_accuracy} if metrics is None else metrics
        self.json_logger = logging.getLogger("stats")
        self.debug_logger = logging.getLogger("debug")
        self.debug_logger.info(self.__str__())

        # client handles: the first num_byzantine ids are byzantine
        self._clients: Dict = {}
        for i, u in enumerate(self.dataset.get_clients()):
            if i < self.num_byzantine:
                self._clients[u] = ByzantineClient(id=u, attack=self.attack)
            else:
                self._clients[u] = BladesClient(id=u)

        self._custom_attack_entries: List = []
        self.server: Optional[BladesServer] = None
        self.engine: Optional[RoundEngine] = None
        self.telemetry: Recorder = NULL_RECORDER
        self.alert_engine: Optional[alerts.AlertEngine] = None
        for name in _IGNORED_KWARGS:
            val = locals().get(name)
            if val not in (None, 0, 1, "actor", False, 0.0):
                self.debug_logger.info(
                    f"note: {name}={val!r} is a Ray-era knob; the device is "
                    "chosen with device= here and the value is ignored."
                )

    def __str__(self) -> str:
        return (
            f"Simulator(num_clients={self.dataset.num_clients}, "
            f"num_byzantine={self.num_byzantine}, attack={self.attack!r}, "
            f"aggregator={self.aggregator!r})"
        )

    # -- reference API --------------------------------------------------------

    def get_clients(self) -> List[BladesClient]:
        return list(self._clients.values())

    def set_trusted_clients(self, ids: List) -> None:
        """Mark client ids trusted (FLTrust bootstrap)."""
        for u in ids:
            self._clients[u].trust()

    def register_attackers(self, clients: List[ByzantineClient]) -> None:
        """Replace the first ``len(clients)`` clients with these attackers
        (reference ``simulator.py:167-187``); ``num_byzantine`` rises to at
        least their number, and ``run`` then applies each one's own attack
        to its own row. Call before :meth:`run`."""
        users = list(self._clients.keys())
        if len(clients) > len(users):
            raise ValueError("more attackers than clients")
        self._custom_attack_entries = []
        for i, c in enumerate(clients):
            c._id = users[i]
            self._clients[users[i]] = c
            self._custom_attack_entries.append((i, c))
        self.num_byzantine = max(self.num_byzantine, len(clients))

    # -- run ------------------------------------------------------------------

    @staticmethod
    def _resolve_schedule(sched, lr0: float) -> Callable[[int], float]:
        if sched is None:
            return lambda r: lr0
        if callable(sched):
            return sched
        if isinstance(sched, dict):
            return multistep_lr(lr0, sched.get("milestones", ()), sched.get("gamma", 0.5))
        raise TypeError(f"bad lr scheduler {sched!r}")

    @staticmethod
    def _resolve_opt(opt, cls):
        if isinstance(opt, cls):
            return opt
        if isinstance(opt, str):
            name = opt.lower()
            if name in ("sgd", "adam"):
                return cls(name=name)
        raise ValueError(f"Unsupported optimizer {opt!r} (use 'SGD', 'Adam', or a spec)")

    def _model_spec(self, model, loss, compute_dtype=None) -> ModelSpec:
        """A :class:`ModelSpec` from a registry name, a module or a spec
        (``blades_tpu/simulator.py:1194-1240``). A prebuilt spec asked for a
        ``compute_dtype`` is rebuilt around its module, keeping its ``init``,
        but only when its functions are stock ``build_fns`` products: a
        rebuild would drop a custom loss or eval function."""
        dtype = _torch_dtype(compute_dtype)
        # text stores hold int32 token ids and a padding id: the model gets
        # the mask ``x != pad_id`` (JAX: ``_build_spec``, :1221-1237)
        pad_id = getattr(self.dataset, "pad_id", None)
        if isinstance(model, ModelSpec):
            if dtype is None:
                return model
            if not model.rebuild_ok:
                raise ValueError(
                    "compute_dtype was requested but this ModelSpec carries "
                    "custom train/eval functions that a rebuild would "
                    "discard; build the spec with the desired compute_dtype "
                    "instead (build_fns(..., compute_dtype=...))"
                )
            rebuilt = build_fns(model.module, loss=loss or "crossentropy", compute_dtype=dtype,
                                pad_id=pad_id)
            rebuilt.init = model.init
            return rebuilt
        if isinstance(model, str):
            # sized from the store's sample shape (its dtype may be uint8:
            # the model sees the sampler's normalized float batches; a text
            # store's shape is its token length)
            model = create_model(model, num_classes=self._num_classes,
                                 sample_shape=self.dataset.sample_shape)
        if isinstance(model, nn.Module):
            return build_fns(model, loss=loss or "crossentropy", compute_dtype=dtype,
                             pad_id=pad_id)
        raise TypeError(f"model must be a registry name, an nn.Module or a ModelSpec, got {model!r}")

    def run(
        self,
        model,
        server_optimizer: Union[str, ServerOptSpec] = "SGD",
        client_optimizer: Union[str, ClientOptSpec] = "SGD",
        loss: Optional[str] = "crossentropy",
        global_rounds: Optional[int] = 1,
        local_steps: Optional[int] = 1,
        validate_interval: Optional[int] = 1,
        test_batch_size: Optional[int] = 64,
        server_lr: Optional[float] = 0.1,
        client_lr: Optional[float] = 0.1,
        server_lr_scheduler=None,
        client_lr_scheduler=None,
        train_batch_size: Optional[int] = None,
        retain_updates: bool = False,
        client_chunks: int = 1,
        remat: bool = False,
        on_round_end: Optional[Callable] = None,
        compute_dtype: Optional[Union[str, torch.dtype]] = None,
        fault_model: Optional[Union[FaultModel, Dict]] = None,
        streaming: bool = False,
        async_config: Optional[Union[AsyncConfig, Dict]] = None,
        block_size: int = 1,
        donate_batches: bool = False,
        engine_cache=None,
        checkpoint_path: Optional[str] = None,
        checkpoint_interval: int = 0,
        resume: bool = False,
        collect_diagnostics: Optional[bool] = None,
        round_metrics: Optional[bool] = None,
        audit_monitor: Optional[Union[AuditMonitor, Dict]] = None,
        profile_dir: Optional[str] = None,
        **options,
    ) -> List[float]:
        """Run adversarial training; returns per-round wall times.

        ``model``: a registry name, an ``nn.Module`` with ``init_params`` and
        ``jax_paths``, or a :class:`ModelSpec`. ``retain_updates``: copy each
        round's update rows onto the client handles. ``client_chunks``:
        train the client axis in this many sequential chunks (activation
        memory scales with the chunk). ``remat``: rematerialize each
        client's loss in local training (``ops/remat.py``, the JAX
        package's ``jax.checkpoint``): the forward keeps no activations and
        the backward recomputes them; the results do not change.
        ``on_round_end(round, state,
        metrics)``: called after every round; the round's post-attack
        ``[K, D]`` matrix is ``self.engine.last_updates``.
        ``compute_dtype``: ``"bfloat16"`` runs local training's forward and
        backward in bf16; params, gradients, the loss and the update matrix
        stay float32.
        ``fault_model``: a :class:`~blades_tpu_torch.faults.FaultModel`, or
        the keyword arguments of one, injecting client dropout, straggler
        replays and payload corruption into every round; the defense then
        aggregates over the clients that delivered, and each round's fault
        counters are ``self.engine.last_fault_diag``.
        ``streaming``: run the streaming round (``RoundEngine`` with
        ``streaming=True``): the defense consumes the ``[K, D]`` update
        matrix one ``[chunk, D]`` slab of ``client_chunks`` at a time, so it
        never exists; a defense, attack or fault model without a streaming
        form raises, and so do ``retain_updates`` and ``on_round_end``,
        which read that matrix.
        ``client_optimizer``: ``"SGD"``, ``"Adam"`` or a
        :class:`ClientOptSpec`; with ``persist=True`` each client's
        optimizer state lives across rounds (``server.state.client_opt_state``).
        ``async_config``: an :class:`~blades_tpu_torch.asyncfl.AsyncConfig`,
        or its keyword arguments (``arrivals`` may be an ``ArrivalProcess``'s),
        runs buffered-asynchronous (FedBuff) rounds: clients arrive on a
        seeded schedule and train from the model they downloaded, the server
        buffers their updates and fires once ``buffer_m`` are in, each
        update weighted by its staleness; each round's counters are
        ``self.engine.last_async_diag``. Not with ``streaming=True`` or a
        fault model with stragglers.
        ``block_size``: run the rounds in blocks of this many through
        ``RoundEngine.run_block``, the sampler fused in; a remainder block
        takes ``global_rounds % block_size``. The ``train`` and
        ``variance`` records are the per-round ones, read back once a
        block; evaluation runs at block boundaries, after a block holding a
        multiple of ``validate_interval``. On the card a graph-safe
        configuration replays one captured CUDA graph of the round
        (``self.engine.last_block_mode``); elsewhere blocks run eagerly
        (``self.engine.last_block_reason`` says why). ``retain_updates`` and
        ``on_round_end`` need every round on the host, so with either the
        run goes round by round (a debug note says so).
        ``donate_batches``: accepted for parity with the JAX package and
        changes nothing: the Simulator always hands each round's batch to
        the engine (``RoundEngine.run_round_donated``) and keeps no
        reference to it, so the caching allocator may reuse its memory once
        local training has consumed it. In a block the engine owns its
        batches already, and a captured round reads a static batch buffer.
        ``engine_cache``: a :class:`~blades_tpu_torch.sweeps.EngineCache`;
        a run whose static configuration matches an earlier run's reuses
        its engine, and with it the engine's captured graph (the key is
        built as in ``blades_tpu/simulator.py:640-715``: a registry model
        name only, no registered attackers, nothing holding a bare
        callable; the fault model is rebound on a hit).
        ``checkpoint_path`` / ``checkpoint_interval``: save the whole
        ``RoundState`` there (``utils/checkpoint.py``, atomic) after every
        round that is a multiple of the interval; with blocks, after every
        block holding such a round, so a checkpoint holds a block boundary.
        On any exception the state of the last completed round (or block)
        is saved to ``checkpoint_path``, else to ``<log_path>/autosave``,
        and the exception re-raised. ``resume``: continue from
        ``checkpoint_path``, else from that autosave, at the round after
        the saved one, bit for bit (``BLADES_RESUME=1`` in the environment
        means ``resume=True``). A fresh run and a completed run remove a
        leftover implicit autosave, never ``checkpoint_path``.
        Attackers registered with :meth:`register_attackers` replace the
        uniform attack.
        ``collect_diagnostics`` (default ``BLADES_TELEMETRY_DIAG=1``): each
        round's ``defense`` record, what the defense decided (trimmed mean's
        trim counts, Krum's scores and selection, centered clipping's clip
        norms, FLTrust's trust scores) with the byzantine share of it; not
        with ``streaming=True``. ``audit_monitor``: an
        :class:`~blades_tpu_torch.audit.AuditMonitor` or its keyword
        arguments; each round's certificates, and the fallback's aggregate
        on a breach, as the ``audit`` record. ``round_metrics`` (default
        ``BLADES_ROUND_METRICS=1``): each round's metric pack (update-norm
        quantiles and histogram, honest and byzantine cosines to the applied
        aggregate, per-chunk extremes) as the ``metrics`` record. All three
        land in ``<log_path>/telemetry.jsonl`` and, for the last round, in
        ``self.engine.last_diagnostics`` / ``last_audit_diag`` /
        ``last_metric_pack``. ``profile_dir`` (or ``BLADES_PROFILE``): a
        ``torch.profiler`` capture of about 3 rounds, exported to
        ``<profile_dir>/trace.json``; a capture that fails is a ``profile``
        record with ``ok: false``, not a failed run.
        """
        for name in options:
            raise TypeError(f"run() got an unexpected keyword argument {name!r}")
        resume = resume or os.environ.get(RESUME_ENV) == "1"
        if collect_diagnostics is None:
            collect_diagnostics = os.environ.get("BLADES_TELEMETRY_DIAG") == "1"
        if round_metrics is None:
            round_metrics = os.environ.get("BLADES_ROUND_METRICS") == "1"
        profile_dir = profile_dir or profiling.profile_dir_from_env()

        if isinstance(fault_model, dict):
            fault_model = FaultModel(**fault_model)
        if isinstance(audit_monitor, dict):
            audit_monitor = AuditMonitor(**audit_monitor)
        if isinstance(async_config, dict):
            async_config = AsyncConfig(**async_config)
        if streaming and (retain_updates or on_round_end is not None):
            raise ValueError(
                "streaming=True never materializes the [K, D] update matrix "
                "that retain_updates/on_round_end read; run dense for those"
            )
        rec, ledger_entry = self._start_trace(
            resume, model, fault_model, audit_monitor, async_config, {
                "global_rounds": global_rounds, "local_steps": local_steps,
                "train_batch_size": train_batch_size or self._train_bs, "client_lr": client_lr,
                "server_lr": server_lr, "client_chunks": client_chunks,
                "block_size": block_size, "streaming": streaming})
        round_times: List[float] = []
        self._capture = None  # the open profiler capture, if any
        built = False  # a failure before the round loop has no state to autosave
        prev_sigterm = None
        try:
            spec = self._model_spec(model, loss, compute_dtype)
            batch_size = train_batch_size or self._train_bs
            params = spec.init(rng.generator(self.seed, 0, rng.INIT))
            trusted = torch.tensor([c.is_trusted() for c in self.get_clients()], dtype=torch.bool)
            attack = self.attack
            if self._custom_attack_entries:
                attack = _CompositeAttack(self._custom_attack_entries)
            engine_kwargs = dict(
                num_clients=self.dataset.num_clients,
                num_byzantine=self.num_byzantine,
                attack=attack,
                aggregator=self.aggregator,
                client_opt=self._resolve_opt(client_optimizer, ClientOptSpec),
                server_opt=self._resolve_opt(server_optimizer, ServerOptSpec),
                num_classes=self._num_classes,
                trusted_mask=trusted,
                client_chunks=client_chunks,
                remat=bool(remat),
                keep_updates=retain_updates or on_round_end is not None,
                device=self.device,
                fault_model=fault_model,
                streaming=streaming,
                async_config=async_config,
                collect_diagnostics=collect_diagnostics,
                audit_monitor=audit_monitor,
                round_metrics=round_metrics,
            )
            engine_key = None
            if (engine_cache is not None and isinstance(model, str)
                    and not self._custom_attack_entries):
                view = static_fingerprint({"model": model, "loss": loss,
                                           "compute_dtype": str(compute_dtype),
                                           **engine_kwargs, "device": str(self.device)})
                if not contains_callables(view):
                    engine_key = program_fingerprint(view=view)
            cached = engine_cache.get(engine_key) if engine_key is not None else None
            if cached is not None:
                self.engine = cached
                # an equal-program fault model (a NaN/Inf twin: the fill rides
                # the state) is rebound; init below makes its state
                self.engine.fault_model = fault_model
                rec.event("engine_cache", hit=1, key=engine_key)
            else:
                t_build = time.perf_counter()
                self.engine = RoundEngine(
                    spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                    noise_sites=spec.noise_sites, **engine_kwargs,
                )
                if engine_key is not None:
                    engine_cache.put(engine_key, self.engine,
                                     build_s=time.perf_counter() - t_build)
            # the round's update-matrix footprint rides every round record
            rec.gauge("engine.peak_update_bytes", self.engine.peak_update_bytes)
            rec.gauge("engine.client_chunks", self.engine.client_chunks)
            rec.gauge("engine.chunk_size", self.engine.chunk_size)
            rec.gauge("engine.streaming", int(self.engine.streaming))
            if async_config is not None:
                rec.gauge("engine.async", 1)
                rec.gauge("engine.async_buffer_m", self.engine.async_buffer_m)
            # a supervisor's SIGTERM becomes SupervisorTermination, so the
            # crash autosave below fires before its SIGKILL; installed only
            # now, when every configuration error has had its chance to
            # raise (blades_tpu/simulator.py:728-745), restored in finally
            prev_sigterm = _install_sigterm()
            state = self.engine.init(params)
            # the crash autosave's target: the checkpoint path when given, else
            # a fixed path in the log dir (whose wipe keeps *.npz)
            autosave_path = checkpoint_path or os.path.join(self.log_path, "autosave")
            start_round = 1
            if resume:
                for cand in dict.fromkeys((checkpoint_path, autosave_path)):
                    if cand and os.path.exists(checkpoint_file(cand)):
                        with rec.span("restore"):
                            state = restore_state(cand, state)
                        start_round = state.round_idx + 1
                        self.debug_logger.info(f"resumed from {cand} at round {start_round}")
                        break
            elif checkpoint_path is None:
                # a fresh run: a leftover implicit autosave belongs to another run
                self._remove_autosave(autosave_path, "fresh run")
            self.server = BladesServer(self.engine, state, self.aggregator)
            client_lr_fn = self._resolve_schedule(client_lr_scheduler, client_lr)
            server_lr_fn = self._resolve_schedule(server_lr_scheduler, server_lr)

            block_size = max(1, int(block_size))
            if block_size > 1 and (retain_updates or on_round_end is not None):
                self.debug_logger.info(
                    "block_size>1 disabled: retain_updates/on_round_end need "
                    "per-round host visibility"
                )
                block_size = 1

            global_start = time.time()
            # the profiler's window: about 3 rounds, past round 1 where the run
            # is long enough
            prof_first = min(max(start_round, 2), global_rounds)
            prof_last = min(prof_first + 2, global_rounds)
            built = True
            if block_size > 1:
                self._run_blocks(state, self.dataset.sampler(local_steps, batch_size),
                                 block_size, start_round, global_rounds, local_steps,
                                 validate_interval, test_batch_size, client_lr_fn,
                                 server_lr_fn, round_times, global_start, checkpoint_path,
                                 checkpoint_interval, profile_dir, prof_first, prof_last)
            else:
                for rnd in range(start_round, global_rounds + 1):
                    if profile_dir and rnd == prof_first:
                        self._capture = profiling.start_capture(profile_dir, rec, self.device)
                    round_start = time.time()
                    with rec.span("round"):
                        with rec.span("sample"):
                            batch = list(self.dataset.sample_round(
                                rng.generator(self.seed, rnd, rng.DATA, device=self.device),
                                local_steps,
                                batch_size,
                            ))
                        c_lr = client_lr_fn(rnd - 1)
                        s_lr = server_lr_fn(rnd - 1)
                        # the engine empties the list: nothing else holds the
                        # batch; it records the round/dispatch span
                        state, m = self.engine.run_round_donated(state, batch, c_lr, s_lr,
                                                                 self.seed)
                        self.server.state = state
                        with rec.span("sync"):
                            self._sync()
                        # the round's launch window closes at this existing
                        # wait (no host sync of its own)
                        timeline.launch_ready()
                        host = self._round_records(
                            [rnd], local_steps, self.engine.round_outputs(m), stacked=False)
                        if retain_updates:
                            for i, c in enumerate(self.get_clients()):
                                c.save_update(self.engine.last_updates[i])
                        if on_round_end is not None:
                            on_round_end(rnd, state, m)
                        if rnd % validate_interval == 0:
                            with rec.span("eval"):
                                ev = self.evaluate(rnd, test_batch_size)
                            self.debug_logger.info(
                                f"Test global round {rnd}, loss: {ev['Loss']}, top1: {ev['top1']}"
                            )
                        if self._capture is not None and rnd == prof_last:
                            self._stop_capture(profile_dir)
                        if checkpoint_path and checkpoint_interval and rnd % checkpoint_interval == 0:
                            with rec.span("checkpoint"):
                                save_state(checkpoint_path, state)
                    wall = time.time() - round_start
                    round_times.append(wall)
                    self._flush_rounds([rnd], [wall], host)
                    self.debug_logger.info(
                        f"E={rnd}; Client learning rate = {c_lr}; "
                        f"Time cost = {time.time() - global_start}"
                    )
        except BaseException as err:
            # self.server.state is the last completed round's (or block's):
            # both loops set it only once a round (block) has returned. The
            # save is best effort: its failure must not mask ``err``
            if built:
                self._crash_autosave(rec, autosave_path, err)
            # a real error is `crashed`; an interrupt or a termination
            # (a BaseException) is `killed`
            ledger_entry.ended("crashed" if isinstance(err, Exception) else "killed",
                               error=f"{type(err).__name__}: {err}"[:300],
                               metrics={"rounds_completed": len(round_times)})
            raise
        finally:
            if self._capture is not None:
                self._stop_capture(profile_dir)
            # whatever was recorded up to a failure reaches the trace; the
            # file is closed (a later record reopens it)
            rec.event("run_end", rounds_completed=len(round_times))
            rec.close()
            # the terminal ledger record (a no-op after a crash's)
            total = sum(round_times)
            ledger_entry.ended("finished", metrics={
                "rounds_completed": len(round_times),
                **({"rounds_per_sec": round(len(round_times) / total, 4)} if total > 0 else {}),
            })
            if prev_sigterm is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_sigterm)
                except (ValueError, OSError):
                    pass
        if checkpoint_path is None:
            # the run completed: its crash autosave is stale
            self._remove_autosave(autosave_path, "run complete")
        return round_times

    def _crash_autosave(self, rec, autosave_path: str, err: BaseException) -> None:
        crash_state = self.server.state
        try:
            with rec.span("crash_checkpoint"):
                save_state(autosave_path, crash_state)
            rec.event("crash_checkpoint", path=checkpoint_file(autosave_path),
                      round=int(crash_state.round_idx),
                      error=f"{type(err).__name__}: {err}"[:300])
            self.debug_logger.info(
                f"crash after round {crash_state.round_idx} "
                f"({type(err).__name__}: {err}); state saved to "
                f"{checkpoint_file(autosave_path)}; run again with resume=True")
        except Exception as save_err:  # noqa: BLE001 - keep the original error
            rec.event("crash_checkpoint_failed", error=str(save_err)[:300])
            self.debug_logger.info(f"crash autosave failed: {save_err!r}")

    def _start_trace(self, resume, model, fault_model, audit_monitor, async_config, run_kw):
        """Mint the run's identity, install a recorder writing
        ``<log_path>/telemetry.jsonl`` with the JAX ``meta`` fields, reset
        the dispatch accounting, attach the alert engine and append the
        ledger's ``started`` record (``blades_tpu/simulator.py:481-570``);
        returns the recorder and the ledger entry. A fresh run starts the
        trace anew; a resumed one appends to it, and so does a supervised
        one (``BLADES_SUPERVISED=1``: its supervisor may have written
        there). The meta record is written at once, so a run that dies
        before its first round leaves a trace."""
        context.activate(fresh=True)
        run_config = {
            "kind": "simulator",
            "num_clients": self.dataset.num_clients,
            "num_byzantine": self.num_byzantine,
            "attack": repr(self.attack),
            "aggregator": repr(self.aggregator),
            "seed": self.seed,
            "model": model if isinstance(model, str) else type(model).__name__,
            **run_kw,
            **({"fault_model": repr(fault_model)} if fault_model else {}),
            **({"async_config": repr(async_config)} if async_config is not None else {}),
        }
        trace_path = os.path.join(self.log_path, "telemetry.jsonl")
        if not resume and os.environ.get(heartbeat.SUPERVISED_ENV) != "1":
            try:
                os.unlink(trace_path)
            except OSError:
                pass
        meta = {
            "run": "simulator",
            "config_fingerprint": config_fingerprint(run_config),
            "num_clients": self.dataset.num_clients,
            "num_byzantine": self.num_byzantine,
            "attack": repr(self.attack),
            "aggregator": repr(self.aggregator),
            "global_rounds": run_kw["global_rounds"],
            "local_steps": run_kw["local_steps"],
            "device": str(self.device),
        }
        for name, part in (("fault_model", fault_model), ("audit_monitor", audit_monitor),
                           ("async_config", async_config)):
            if part is not None:
                meta[name] = repr(part)
        rec = Recorder(path=trace_path, meta=meta)
        self.telemetry = rec
        set_recorder(rec)  # the engine's dispatch spans land here
        # a previous run's unemitted launch splits must not reach round 1
        timeline.reset()
        # the alert rules ride the records the run writes anyway (None when
        # telemetry or alerting is off)
        self.alert_engine = alerts.install(rec)
        rec.flush()
        entry = ledger.run_started("simulator", config=run_config, artifacts=[trace_path])
        return rec, entry

    def _sync(self) -> None:
        """Wait for the device (the round's execution lands in the ``sync``
        span)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stop_capture(self, profile_dir) -> None:
        profiling.stop_capture(profile_dir, self._capture, self.telemetry)
        self._capture = None

    def _round_records(self, rounds, local_steps, outs, stacked: bool = True):
        """The ``stats`` and telemetry records of ``rounds`` from their
        outputs (``RoundEngine.round_outputs`` order; stacked ``[R]`` for a
        block), read from the device in one copy (the forensics only when
        telemetry is on). Returns the host metrics."""
        if not self.telemetry.enabled:
            outs = (outs[0],) + (None,) * (len(outs) - 1)
        metrics, *diags = outputs_to_host(outs)
        for i, r in enumerate(rounds):
            pick = (lambda tree: tree_map(lambda a: a[i], tree)) if stacked else (lambda t: t)
            m = pick(metrics)
            self.log_train(r, local_steps, m)
            self.log_variance(r, m)
            for name, diag in zip(BLOCK_DIAGS, diags):
                if diag is not None:  # _log_defense, _log_faults, ...
                    getattr(self, f"_log_{name}")(r, pick(diag))
        return metrics

    def _flush_rounds(self, rounds, walls, metrics) -> None:
        """The round's (block's) ``timeline`` record, each round's ``round``
        record (the device's memory gauges riding it), the trace's one
        buffered write, and the heartbeat."""
        rec = self.telemetry
        profiling.record_live_bytes(rec, self.device)
        timeline.emit(rec, round_idx=rounds[-1])
        for i, (r, wall) in enumerate(zip(rounds, walls)):
            loss, top1 = metrics.train_loss, metrics.train_top1
            if np.ndim(loss):  # a block's [R]
                loss, top1 = loss[i], top1[i]
            rec.round_record(r, wall_s=wall, train_loss=float(loss), train_top1=float(top1))
        rec.flush()
        heartbeat.beat(round_idx=rounds[-1])

    def _remove_autosave(self, autosave_path: str, why: str) -> None:
        stale = checkpoint_file(autosave_path)
        try:
            os.unlink(stale)
        except FileNotFoundError:
            return
        except OSError as err:
            self.debug_logger.info(f"{why}: could not remove crash autosave {stale}: {err}")
            return
        self.debug_logger.info(f"{why}: removed stale crash autosave {stale}")

    def _run_blocks(self, state, sampler, block_size, start_round, global_rounds, local_steps,
                    validate_interval, test_batch_size, client_lr_fn, server_lr_fn,
                    round_times, global_start, checkpoint_path, checkpoint_interval,
                    profile_dir=None, prof_first=0, prof_last=0) -> None:
        """Rounds ``start_round..global_rounds`` in blocks of ``block_size``
        through ``RoundEngine.run_block`` (``blades_tpu/simulator.py:
        1048-1192``), a remainder block taking the rest. Each block's
        metrics and forensics come to the host in one copy and are logged
        round by round (each round's slice of the ``[R]`` outputs);
        evaluation runs once a block, and so do the checkpoint (a block
        boundary) and the trace's flush; ``round_times`` gets each round's
        share of its block's wall; the state after each block is left on
        ``self.server``."""
        rec = self.telemetry
        rnd = start_round
        while rnd <= global_rounds:
            bs = min(block_size, global_rounds - rnd + 1)
            rounds = list(range(rnd, rnd + bs))
            if profile_dir and self._capture is None and rnd <= prof_first < rnd + bs:
                self._capture = profiling.start_capture(profile_dir, rec, self.device)
            block_start = time.time()
            with rec.span("block", rounds=bs):
                c_lrs = [client_lr_fn(r - 1) for r in rounds]
                s_lrs = [server_lr_fn(r - 1) for r in rounds]
                # records the block/dispatch span
                state, ms, diags = self.engine.run_block(state, rounds, c_lrs, s_lrs, self.seed,
                                                         sampler=sampler)
                self.server.state = state
                with rec.span("sync"):
                    self._sync()
                timeline.launch_ready()
                # the block's one host read: every round's metrics and forensics
                host = self._round_records(rounds, local_steps,
                                           (ms,) + tuple(diags[k] for k in BLOCK_DIAGS))
                if any(r % validate_interval == 0 for r in rounds):
                    with rec.span("eval"):
                        ev = self.evaluate(rounds[-1], test_batch_size)
                    self.debug_logger.info(
                        f"Test global round {rounds[-1]}, loss: {ev['Loss']}, top1: {ev['top1']}"
                    )
                if self._capture is not None and rounds[-1] >= prof_last:
                    self._stop_capture(profile_dir)
                if checkpoint_path and checkpoint_interval and any(
                        r % checkpoint_interval == 0 for r in rounds):
                    with rec.span("checkpoint"):
                        save_state(checkpoint_path, state)
            wall = time.time() - block_start
            round_times.extend([wall / bs] * bs)
            self._flush_rounds(rounds, [wall / bs] * bs, host)
            self.debug_logger.info(
                f"E={rounds[0]}-{rounds[-1]}; block={bs} ({self.engine.last_block_mode}); "
                f"Client learning rate = {c_lrs[-1]}; Time cost = {time.time() - global_start}"
            )
            rnd += bs

    # -- logging (stats-file schema parity) -----------------------------------

    def log_train(self, rnd: int, local_steps: int, m) -> None:
        r = {
            "_meta": {"type": "train"},
            "Round": rnd,
            "B": local_steps,
            "Loss": float(m.train_loss),
            "top1": float(m.train_top1),
        }
        self.json_logger.info(r)
        self.debug_logger.info(
            f"[Round{rnd:3d}] Loss: {r['Loss']:.4f} top1={r['top1']:8.4f}"
        )

    def log_variance(self, rnd: int, m) -> None:
        r = {
            "_meta": {"type": "variance"},
            "Round": rnd,
            "avg": float(m.update_variance),
            "norm": float(m.update_variance_norm),
        }
        self.json_logger.info(r)

    # -- telemetry forensics (blades_tpu/simulator.py:1262-1395) ------------------
    #
    # Each takes one round's diagnostics as numpy arrays (the host copy that
    # the per-round and the block loops read once), writes one record and
    # sets its gauges.

    def _log_defense(self, rnd: int, diag) -> None:
        """The ``defense`` record: the defense's diagnostics and how much of
        what it selected, trimmed, clipped or trusted was byzantine (ground
        truth the simulator knows and a deployment would not)."""
        if not diag or not self.telemetry.enabled:
            return
        byz = np.arange(self.engine.num_clients) < self.engine.num_byzantine
        fields = {}
        for name, v in diag.items():
            arr = np.asarray(v)
            fields[name] = arr.tolist() if arr.ndim else arr.item()
        overlap = {}
        if "selected" in diag:  # krum / multikrum: byzantine share of the selection
            overlap["byz_selected_frac"] = float(byz[np.asarray(diag["selected"])].mean())
        if "trim_counts" in diag:  # trimmed mean: byzantine share of the trimmed slots
            tc = np.asarray(diag["trim_counts"], dtype=np.float64)
            tot = tc.sum()
            overlap["byz_trim_frac"] = float(tc[byz].sum() / tot) if tot else 0.0
        if "clipped" in diag:  # centered clipping: who hit the clip radius
            cl = np.asarray(diag["clipped"])
            overlap["byz_clipped_frac"] = float(cl[byz].mean()) if byz.any() else 0.0
            overlap["honest_clipped_frac"] = float(cl[~byz].mean()) if (~byz).any() else 0.0
        if "trust_scores" in diag:  # fltrust: byzantine share of the trust mass
            ts = np.asarray(diag["trust_scores"], dtype=np.float64)
            tot = ts.sum()
            overlap["byz_trust_frac"] = float(ts[byz].sum() / tot) if tot > 0 else 0.0
        for name, value in overlap.items():
            self.telemetry.gauge(f"defense.{name}", value)
        self.telemetry.event("defense", round=rnd, agg=repr(self.aggregator), **fields,
                             **overlap)

    def _log_faults(self, rnd: int, diag) -> None:
        """The ``faults`` record: participants, dropouts, stale replays,
        expired stragglers, corrupted payloads, non-finite exclusions; the
        counts also as gauges."""
        if not diag or not self.telemetry.enabled:
            return
        fields = {name: int(np.asarray(v)) for name, v in diag.items()}
        for name, value in fields.items():
            self.telemetry.gauge(f"faults.{name}", value)
        self.telemetry.event("faults", round=rnd, **fields)

    def _log_audit(self, rnd: int, diag) -> None:
        """The ``audit`` record: the certificates' verdicts, the breach and
        fallback flags and the honest-deviation fields; the headline flags
        also as gauges, breaches as a counter."""
        if not diag or not self.telemetry.enabled:
            return
        fields = {}
        for name, v in diag.items():
            arr = np.asarray(v)
            fields[name] = arr.item() if arr.ndim == 0 else arr.tolist()
        for name in ("breach", "fallback_used", "dev_honest"):
            if name in fields:
                self.telemetry.gauge(f"audit.{name}", fields[name])
        self.telemetry.counter("audit.breaches", fields.get("breach", 0))
        self.telemetry.event("audit", round=rnd, agg=repr(self.aggregator), **fields)

    def _log_async(self, rnd: int, diag) -> None:
        """The ``async`` record: the tick's 10 counters; the buffer and fire
        headline also as gauges, fires as a counter."""
        if not diag or not self.telemetry.enabled:
            return
        fields = {}
        for name, v in diag.items():
            arr = np.asarray(v)
            fields[name] = float(arr) if arr.dtype.kind == "f" else int(arr)
        for name in ("buffer_count", "fired", "mean_staleness"):
            self.telemetry.gauge(f"async.{name}", fields[name])
        self.telemetry.counter("async.fires", fields.get("fired", 0))
        self.telemetry.event("async", round=rnd, **fields)

    def _log_metrics(self, rnd: int, pack) -> None:
        """The ``metrics`` record: the round's metric pack
        (``telemetry/metric_pack.py``); its headline geometry also as
        gauges."""
        if not self.telemetry.enabled:
            return
        fields = pack_to_fields(pack)
        for name in ("cos_honest", "cos_byz", "norm_median", "participants"):
            self.telemetry.gauge(f"metrics.{name}", fields[name])
        self.telemetry.event("metrics", round=rnd, **fields)

    def evaluate(self, rnd: int, batch_size: int = 64) -> Dict:
        """Every client evaluates the global model on its own test shard (one
        ``client_validation`` record each), then the data-size-weighted
        average is logged as the ``test`` record; one batched forward pass
        computes all of it."""
        losses, correct = self.engine.evaluate_per_sample(
            self.server.state,
            self.dataset.test_x,
            self.dataset.test_y,
            batch_size=batch_size,
        )
        n = losses.shape[0]
        shards = self.dataset.client_test_slices()
        for u, idx in zip(self._clients, shards):
            if len(idx) == 0:
                continue
            r = {
                "_meta": {"type": "client_validation"},
                "E": rnd,
                "id": u,
                "Length": int(len(idx)),
                "Loss": float(losses[idx].mean()),
                "top1": float(correct[idx].mean()),
            }
            self.json_logger.info(r)
        ev = {"Loss": float(np.mean(losses)), "top1": float(np.mean(correct))}
        r = {
            "_meta": {"type": "test"},
            "Round": rnd,
            "top1": ev["top1"],
            "Length": n,
            "Loss": ev["Loss"],
        }
        self.json_logger.info(r)
        return ev
