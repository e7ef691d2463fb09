"""The federated round engine, dense synchronous path.

Counterpart: ``blades_tpu/core/engine.py`` — ``ClientOptSpec`` /
``ServerOptSpec`` (:67-122), ``RoundState`` / ``RoundMetrics`` (:125-153),
``RoundEngine.init`` (:456), ``_local_update`` (:569-625),
``_train_clients`` (:638-712), ``_round_dense`` (:714-874, its fault branch
:749-797), ``run_round`` (:1113), ``evaluate_per_sample`` (:1344) and
``multistep_lr`` (:1374).

One call to :meth:`RoundEngine.run_round` runs, on the engine's device:

  1. local training of all K clients from the shared global params: per
     local step, the step's dropout and DropPath keep-masks for all K
     clients at once (one generator per round, ``utils/rng.py:DROPOUT``),
     then, chunk by chunk, one ``torch.func.vmap`` of ``grad_and_value``
     over the client axis (the loss clamped to ``[0, loss_clamp]`` before
     the gradient, the masks vmapped in), then the client optimizer on the
     ``[K, ...]`` params;
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
  6. the server step with the aggregate as pseudo-gradient, ``grad := -agg``.

The optimizers port optax's chains literally — ``add_decayed_weights``, then
``trace`` (momentum) or ``scale_by_adam`` — and the engine applies
``p -= lr * u`` itself; ``torch.optim`` orders weight decay and momentum
differently. Not ported yet, each raising where it would be selected:
persistent per-client optimizer state (``persist=True``, ``ROADMAP.md``
queue A slice 3b), round blocks (slice 7), streaming (slice 8), async
(slice 9), audit, diagnostics and the metric pack (slice 10), and sharding
plans (slice 12).

``remat`` (the JAX engine's ``jax.checkpoint`` around each client's loss)
is not ported (``ROADMAP.md`` queue A, slice 2b): ``torch.func.grad``
refuses ``torch.utils.checkpoint`` in both its forms (saved-tensor hooks,
and an ``autograd.Function`` without ``setup_context``). ``client_chunks``
bounds activation memory instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.attackers.base import Attack, NoAttack
from blades_tpu_torch.faults import FaultModel
from blades_tpu_torch.ops.pytree import FlatLayout, Params, make_unraveler, ravel
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


class _AddDecayedWeights:
    def __init__(self, weight_decay: float):
        self.wd = weight_decay

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return {n: g + self.wd * params[n] for n, g in grads.items()}, state


class _Trace:
    """``optax.trace(decay)``: ``t = g + decay * t``; the update is ``t``."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, params):
        return {n: torch.zeros_like(p) for n, p in params.items()}

    def update(self, grads, state, params):
        t = {n: g + self.decay * state[n] for n, g in grads.items()}
        return t, t


class _ScaleByAdam:
    """``optax.scale_by_adam`` with ``eps_root=0``."""

    def __init__(self, b1: float, b2: float, eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        return (0, zeros(), zeros())

    def update(self, grads, state, params):
        count, mu, nu = state
        mu = {n: (1 - self.b1) * g + self.b1 * mu[n] for n, g in grads.items()}
        nu = {n: (1 - self.b2) * g * g + self.b2 * nu[n] for n, g in grads.items()}
        count += 1
        c1 = 1 - self.b1**count
        c2 = 1 - self.b2**count
        updates = {
            n: (mu[n] / c1) / (torch.sqrt(nu[n] / c2) + self.eps) for n in grads
        }
        return updates, (count, mu, nu)


class _Chain:
    def __init__(self, parts):
        self.parts = parts

    def init(self, params):
        return tuple(p.init(params) for p in self.parts)

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
    client_opt_state: Any  # () while per-client state is not persisted
    agg_state: Any
    attack_state: Any
    round_idx: int
    # the fault model's straggler buffer and fill; () without a fault model
    fault_state: Any = ()


class RoundMetrics(NamedTuple):
    train_loss: torch.Tensor  # scalar: mean loss over honest clients
    train_loss_all: torch.Tensor  # scalar: mean loss over all clients
    train_top1: torch.Tensor  # scalar: mean train top-1 over honest clients
    update_variance: torch.Tensor  # scalar: mean per-coord variance of updates
    update_variance_norm: torch.Tensor  # L2 norm of the per-coord variance
    agg_norm: torch.Tensor  # L2 norm of the aggregated update


def chunk_layout(num_rows: int, num_chunks: int) -> Tuple[int, int]:
    """``(num_chunks, chunk_size)``: the chunk count clamps to the
    population, chunks are ceil-sized and the count is renormalized so no
    chunk is empty (``blades_tpu/ops/streaming.py:49``). The final chunk may
    be short: an eager loop needs no padding to keep one compiled shape."""
    c = max(1, min(int(num_chunks), int(num_rows)))
    chunk = -(-int(num_rows) // c)
    return -(-int(num_rows) // chunk), chunk


class RoundEngine:
    """Runs federated rounds and evaluation on one device.

    ``train_loss_fn``: ``(params, x, y, noise) -> (loss, {"top1": ...})``;
    ``eval_logits_fn``: ``(params, x) -> logits``; ``layout``: the params'
    flat order (``ModelSpec.layout``); ``noise_sites``: ``batch -> {name:
    (shape, keep)}``, the keep-masks ``train_loss_fn`` takes
    (``ModelSpec.noise_sites``; None for a model that draws nothing).

    ``client_chunks`` splits the K client axis into sequential chunks, each
    trained as one vmapped batch, so activation memory scales with the
    chunk, not with K; the masks are drawn for all K clients before the
    split, so a round does not depend on it. ``keep_updates`` keeps each
    round's post-attack ``[K, D]`` matrix as ``self.last_updates`` (under a
    fault model, the matrix the server received). ``fault_model``: a
    :class:`~blades_tpu_torch.faults.FaultModel` injecting dropout,
    straggler replays and payload corruption; each round's counters are
    then ``self.last_fault_diag`` (None without one, and the round is the
    same code path as before the fault model existed).
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
    ):
        if client_opt.persist:
            raise NotImplementedError(
                "persistent per-client optimizer state (persist=True) is not "
                "ported to blades_tpu_torch yet (ROADMAP.md queue A, slice 3b)"
            )
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
        self.client_chunks, self.chunk_size = chunk_layout(
            self.num_clients, int(client_chunks)
        )
        self.keep_updates = bool(keep_updates)
        self.last_updates: Optional[torch.Tensor] = None
        self.fault_model = fault_model
        self.last_fault_diag: Optional[dict] = None
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

        # one client's (grads, (loss, aux)), mapped over the client axis
        self._grad_fn = vmap(grad_and_value(clamped_loss, has_aux=True))
        self._ravel_rows = vmap(lambda p: ravel(p, self.layout))

    # -- state ---------------------------------------------------------------

    def init(self, params: Params) -> RoundState:
        # a private float32 copy on the engine's device: the round never
        # aliases the caller's tensors
        params = {
            n: t.detach().to(self.device, torch.float32).clone() for n, t in params.items()
        }
        agg_state = (
            self.aggregator.init_state(self.num_clients, self.dim)
            if self.aggregator is not None
            else ()
        )
        return RoundState(
            params=params,
            server_opt_state=self._server_tx.init(params),
            client_opt_state=(),
            agg_state=agg_state,
            attack_state=self.attack.init_state(self.num_clients, self.dim),
            round_idx=0,
            fault_state=(
                self.fault_model.init_state(self.num_clients, self.dim, device=self.device)
                if self.fault_model is not None
                else ()
            ),
        )

    # -- the round -------------------------------------------------------------

    def _train_clients(self, params, client_lr, cx, cy, noise_gen):
        """Local training of all K clients (``_local_update`` with the client
        axis written out): ``(updates [K, D], losses [K], top1s [K])``. Each
        local step draws every client's keep-masks from ``noise_gen`` at
        once, then trains the chunks in turn on their slices."""
        k_all, steps, batch = cx.shape[:3]
        ids = torch.arange(self.num_clients, device=self.device)
        chunks = [slice(lo, lo + self.chunk_size) for lo in range(0, k_all, self.chunk_size)]
        ps = [{n: t.expand(ids[c].numel(), *t.shape) for n, t in params.items()} for c in chunks]
        opt_states = [self._client_tx.init(p) for p in ps]
        sites = self.noise_sites(batch)
        losses, top1s = [], []  # per step, each a list over the chunks
        for s in range(steps):
            noise = rng.keep_masks(sites, noise_gen, (k_all,))
            losses.append([])
            top1s.append([])
            for i, rows in enumerate(chunks):
                p, byz = ps[i], self.byz_mask[rows]
                x, y = self.attack.on_batch(
                    cx[rows, s], cy[rows, s], byz, num_classes=self.num_classes,
                    client_idx=ids[rows],
                )
                grads, (loss, aux) = self._grad_fn(
                    p, x, y, {n: m[rows] for n, m in noise.items()}
                )
                grads = self.attack.on_grads(grads, byz, client_idx=ids[rows])
                u, opt_states[i] = self._client_tx.update(grads, opt_states[i], p)
                ps[i] = {n: p[n] - client_lr * u[n] for n in p}
                losses[-1].append(loss)
                top1s[-1].append(aux.get("top1", torch.full_like(loss, float("nan"))))
            del noise
        updates = torch.cat([self._ravel_rows(p) for p in ps]) - ravel(params, self.layout)
        over_steps = lambda xs: torch.stack([torch.cat(x) for x in xs], 1).mean(1)  # noqa: E731
        return updates, over_steps(losses), over_steps(top1s)

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
        if self.aggregator is None:
            raise ValueError("RoundEngine.run_round needs an aggregator")
        r = state.round_idx
        updates, losses, top1s = self._train_clients(
            state.params, client_lr, cx, cy,
            rng.generator(seed, r, rng.DROPOUT, device=self.device),
        )

        # parity: the reference nan_to_num's every uploaded update
        updates = torch.nan_to_num(updates)
        updates, attack_state = self.attack.on_updates(
            updates, self.byz_mask, rng.generator(seed, r, rng.ATTACK, device=self.device),
            state.attack_state,
        )
        # the variance metrics stay on the matrix the clients sent
        sent_updates = updates
        fault_state, part_mask, fault_diag = state.fault_state, None, None
        if self.fault_model is not None:
            updates, part_mask, fault_state, fault_diag = self.fault_model.apply(
                updates, state.fault_state,
                rng.generator(seed, r, rng.FAULT, device=self.device), r,
            )
        agg_ctx = dict(
            trusted_mask=self.trusted_mask,
            params_flat=ravel(state.params, self.layout),
            generator=rng.generator(seed, r, rng.AGG, device=self.device),
        )
        if part_mask is None:
            agg, agg_state = self.aggregator.aggregate(updates, state.agg_state, **agg_ctx)
        else:
            agg, agg_state = self.aggregator.aggregate_masked(
                updates, state.agg_state, mask=part_mask, **agg_ctx
            )
            # a round with no participant applies the zero update
            agg = torch.where(part_mask.any(), agg, torch.zeros_like(agg))

        # server pseudo-gradient step: grad := -agg
        server_updates, server_opt_state = self._server_tx.update(
            self.unravel(-agg), state.server_opt_state, state.params
        )
        params = {
            n: p - server_lr * server_updates[n] for n, p in state.params.items()
        }

        honest = (~self.byz_mask).to(losses.dtype)
        n_honest = torch.clamp_min(honest.sum(), 1.0)
        # population variance (ddof 0), as jnp.var: torch.var defaults to ddof 1
        var = sent_updates.var(dim=0, correction=0)
        metrics = RoundMetrics(
            train_loss=(losses * honest).sum() / n_honest,
            train_loss_all=losses.mean(),
            train_top1=(top1s * honest).sum() / n_honest,
            update_variance=var.mean(),
            update_variance_norm=torch.linalg.vector_norm(var),
            agg_norm=torch.linalg.vector_norm(agg),
        )
        self.last_updates = updates if self.keep_updates else None
        self.last_fault_diag = fault_diag
        new_state = RoundState(
            params=params,
            server_opt_state=server_opt_state,
            client_opt_state=(),
            agg_state=agg_state,
            attack_state=attack_state,
            round_idx=r + 1,
            fault_state=fault_state,
        )
        return new_state, metrics

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


def multistep_lr(lr0: float, milestones=(), gamma: float = 0.5) -> Callable[[int], float]:
    """torch ``MultiStepLR`` parity: lr decays by ``gamma`` at each milestone
    round; a host-side float function of the round index."""

    def lr(round_idx: int) -> float:
        return lr0 * (gamma ** sum(1 for m in milestones if round_idx >= m))

    return lr
