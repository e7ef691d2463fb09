"""Simulator: the public orchestrator, reference-API compatible.

Counterpart: ``blades_tpu/simulator.py`` — the constructor
(:152-242, with the strict unknown-kwarg error and the ALIE and label
flipping auto-fills at :194-198), ``run`` for the per-round synchronous
dense loop (:297-1046: model spec, ``engine.init``, ``sample_round`` ->
``run_round`` -> ``log_train`` / ``log_variance``, periodic ``evaluate``;
``fault_model`` as a ``FaultModel`` or its kwargs, :466-467; ``streaming``
and its guard against ``retain_updates`` / ``on_round_end``, :475-479),
the stats records (:1240-1260) and ``evaluate`` (:1396-1437). It writes
the same ``stats`` records (``train``, ``variance``, ``client_validation``,
``test``) with the same keys.

``device=None`` runs on the GPU and raises where CUDA is unavailable; pass
``device="cpu"`` to run on the CPU. Options that select a path not ported
yet raise ``NotImplementedError`` naming the ``ROADMAP.md`` slice (queue A)
that brings it; the JAX package's telemetry trace (with its per-round
``faults`` records: ``engine.last_fault_diag`` holds the counters), run
ledger and supervision hooks come with slice 10 and are not written.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from blades_tpu_torch.aggregators import get_aggregator
from blades_tpu_torch.attackers import get_attack
from blades_tpu_torch.client import BladesClient, ByzantineClient
from blades_tpu_torch.core.engine import (
    ClientOptSpec,
    RoundEngine,
    ServerOptSpec,
    multistep_lr,
    resolve_device,
)
from blades_tpu_torch.datasets.base import BaseDataset
from blades_tpu_torch.datasets.fl import FLDataset
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.models import create_model
from blades_tpu_torch.models.common import ModelSpec, build_fns
from blades_tpu_torch.server import BladesServer
from blades_tpu_torch.utils import rng
from blades_tpu_torch.utils.logging import initialize_logger
from blades_tpu_torch.utils.metrics import top1_accuracy

_IGNORED_KWARGS = ("num_actors", "num_trainers", "gpu_per_actor", "mode", "use_cuda")

#: run() options of the JAX Simulator whose path is not ported yet:
#: name -> (the value that leaves it off, the ROADMAP.md queue-A slice)
_UNPORTED_RUN_OPTIONS = {
    "remat": (False, "slice 2b (remat under torch.func)"),
    "checkpoint_path": (None, "slice 5 (checkpoint and resume)"),
    "checkpoint_interval": (0, "slice 5 (checkpoint and resume)"),
    "resume": (False, "slice 5 (checkpoint and resume)"),
    "block_size": (1, "slice 7 (multi-round execution)"),
    "donate_batches": (False, "slice 7 (multi-round execution)"),
    "engine_cache": (None, "slice 7 (multi-round execution)"),
    "async_config": (None, "slice 9 (async)"),
    "audit_monitor": (None, "slice 10 (audit, metrics, telemetry)"),
    "collect_diagnostics": (None, "slice 10 (audit, metrics, telemetry)"),
    "round_metrics": (None, "slice 10 (audit, metrics, telemetry)"),
    "profile_dir": (None, "slice 10 (audit, metrics, telemetry)"),
}


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

        self.server: Optional[BladesServer] = None
        self.engine: Optional[RoundEngine] = None
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
        raise _unported("register_attackers (custom per-client attacks)", "slice 3b (composite attacks)")

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
            rebuilt = build_fns(model.module, loss=loss or "crossentropy", compute_dtype=dtype)
            rebuilt.init = model.init
            return rebuilt
        if isinstance(model, str):
            model = create_model(
                model,
                num_classes=self._num_classes,
                sample_shape=tuple(self.dataset.train_x.shape[2:]),
            )
        if isinstance(model, nn.Module):
            return build_fns(model, loss=loss or "crossentropy", compute_dtype=dtype)
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
        on_round_end: Optional[Callable] = None,
        compute_dtype: Optional[Union[str, torch.dtype]] = None,
        fault_model: Optional[Union[FaultModel, Dict]] = None,
        streaming: bool = False,
        **options,
    ) -> List[float]:
        """Run adversarial training; returns per-round wall times.

        ``model``: a registry name, an ``nn.Module`` with ``init_params`` and
        ``jax_paths``, or a :class:`ModelSpec`. ``retain_updates``: copy each
        round's update rows onto the client handles. ``client_chunks``:
        train the client axis in this many sequential chunks (activation
        memory scales with the chunk). ``on_round_end(round, state,
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
        """
        for name, value in options.items():
            if name not in _UNPORTED_RUN_OPTIONS:
                raise TypeError(f"run() got an unexpected keyword argument {name!r}")
            off, slice_name = _UNPORTED_RUN_OPTIONS[name]
            is_off = value in (None, False) if off is None else value == off
            if not is_off:
                raise _unported(f"run({name}={value!r})", slice_name)

        if isinstance(fault_model, dict):
            fault_model = FaultModel(**fault_model)
        if streaming and (retain_updates or on_round_end is not None):
            raise ValueError(
                "streaming=True never materializes the [K, D] update matrix "
                "that retain_updates/on_round_end read; run dense for those"
            )
        spec = self._model_spec(model, loss, compute_dtype)
        batch_size = train_batch_size or self._train_bs
        params = spec.init(rng.generator(self.seed, 0, rng.INIT))
        trusted = torch.tensor([c.is_trusted() for c in self.get_clients()], dtype=torch.bool)
        self.engine = RoundEngine(
            spec.train_loss_fn,
            spec.eval_logits_fn,
            params,
            spec.layout,
            num_clients=self.dataset.num_clients,
            num_byzantine=self.num_byzantine,
            attack=self.attack,
            aggregator=self.aggregator,
            client_opt=self._resolve_opt(client_optimizer, ClientOptSpec),
            server_opt=self._resolve_opt(server_optimizer, ServerOptSpec),
            num_classes=self._num_classes,
            trusted_mask=trusted,
            client_chunks=client_chunks,
            keep_updates=retain_updates or on_round_end is not None,
            device=self.device,
            noise_sites=spec.noise_sites,
            fault_model=fault_model,
            streaming=streaming,
        )
        state = self.engine.init(params)
        self.server = BladesServer(self.engine, state, self.aggregator)
        client_lr_fn = self._resolve_schedule(client_lr_scheduler, client_lr)
        server_lr_fn = self._resolve_schedule(server_lr_scheduler, server_lr)

        round_times: List[float] = []
        global_start = time.time()
        for rnd in range(1, global_rounds + 1):
            round_start = time.time()
            cx, cy = self.dataset.sample_round(
                rng.generator(self.seed, rnd, rng.DATA, device=self.device),
                local_steps,
                batch_size,
            )
            c_lr = client_lr_fn(rnd - 1)
            s_lr = server_lr_fn(rnd - 1)
            state, m = self.engine.run_round(state, cx, cy, c_lr, s_lr, self.seed)
            self.server.state = state
            # the float() reads in the loggers wait for the device
            self.log_train(rnd, local_steps, m)
            self.log_variance(rnd, m)
            if retain_updates:
                for i, c in enumerate(self.get_clients()):
                    c.save_update(self.engine.last_updates[i])
            if on_round_end is not None:
                on_round_end(rnd, state, m)
            if rnd % validate_interval == 0:
                ev = self.evaluate(rnd, test_batch_size)
                self.debug_logger.info(
                    f"Test global round {rnd}, loss: {ev['Loss']}, top1: {ev['top1']}"
                )
            round_times.append(time.time() - round_start)
            self.debug_logger.info(
                f"E={rnd}; Client learning rate = {c_lr}; "
                f"Time cost = {time.time() - global_start}"
            )
        return round_times

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
