"""Shared model plumbing: an ``nn.Module`` -> pure-function adapter.

Counterpart: ``blades_tpu/models/common.py:20-128`` (``cross_entropy``,
``ModelSpec``, ``build_fns``, ``DropPath``). The round engine consumes
``train_loss_fn(params, x, y, noise) -> (loss, {"top1": ...})`` and
``eval_logits_fn(params, x)``; here both call the module through
``torch.func.functional_call`` with a params dict, so the engine can take
per-client gradients with ``torch.func.vmap``.

Randomness in training (dropout, DropPath) comes in pre-drawn: a module that
draws any declares ``noise_sites(batch) -> {name: (shape, keep)}``, one
boolean keep-mask per site with the sample axis first, and its
``forward(x, noise)`` applies them (:func:`dropout`, :func:`drop_path`).
``noise=None`` is the deterministic (eval) forward. The engine draws every
client's masks at once (``utils/rng.py:keep_masks``) and vmaps them in, so
nothing inside ``torch.func.vmap`` touches a global generator. The JAX
package draws the same Bernoulli masks from ``jax.random`` keys; the bits
differ, so tests hand both packages the same masks or set the rates to 0.

:func:`params_from_jax` / :func:`params_to_jax` carry parameters between the
two packages: the JAX side as a nested dict of numpy arrays in flax layout
(a Dense kernel is ``[in, out]``, a Conv kernel ``[kh, kw, in, out]``), this
side as a dict of tensors in torch layout (``ops/pytree.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from blades_tpu_torch.ops.pytree import FlatLayout, Params, flat_dim, make_layout

#: ``{site name: (mask shape with the sample axis first, keep probability)}``
NoiseSites = Dict[str, Tuple[Tuple[int, ...], float]]


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; takes logits or log-probs alike
    (log_softmax is idempotent, so the MLP's log_softmax output gives the
    same loss as its logits would)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, y.long()[..., None]).mean()


def dropout(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """flax ``nn.Dropout`` with its mask given: kept entries scale by
    ``1/keep``, dropped ones are 0; no mask (eval) or rate 0 is the identity."""
    if mask is None or rate == 0.0:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def drop_path(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """``DropPath`` (``blades_tpu/models/common.py:110-128``): a ``[B]`` mask
    keeps or zeroes a whole sample's residual branch, survivors scaled by
    ``1/keep``."""
    if mask is not None:
        mask = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
    return dropout(x, mask, rate)


@dataclasses.dataclass
class ModelSpec:
    """The pure functions the engine needs, the params' flat layout, and
    ``init(generator) -> params`` (CPU tensors, so one seed gives the same
    params whatever device the run uses).

    ``noise_sites(batch)``: the keep-masks ``train_loss_fn`` takes for a
    batch of that size (``{}`` for a model that draws nothing).
    ``rebuild_ok``: the functions are stock :func:`build_fns` products, so a
    consumer may rebuild them from ``module`` with other options (e.g.
    ``compute_dtype``) without losing behaviour."""

    module: nn.Module
    init: Callable[[torch.Generator], Params]
    train_loss_fn: Callable
    eval_logits_fn: Callable
    layout: FlatLayout
    param_count: Optional[int] = None
    noise_sites: Callable[[int], NoiseSites] = lambda batch: {}
    rebuild_ok: bool = False


def build_fns(
    module: nn.Module,
    loss: str = "crossentropy",
    compute_dtype: Optional[torch.dtype] = None,
    pad_id: Optional[int] = None,
) -> ModelSpec:
    """Adapt a module that defines ``init_params(generator)`` and
    ``jax_paths()`` (its map ``torch name -> (flax path, perm)``) to the
    engine's interface.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): mixed precision. Float
    params and inputs are cast to it inside the loss, so the forward and
    backward run in it while the master params and the gradients (through
    the cast) stay float32; the loss is taken in float32; int token ids
    pass uncast. ``pad_id`` (text models, ``blades_tpu/models/common.py:
    72-73``): the loss and eval functions derive the validity mask ``x !=
    pad_id`` from each batch and pass it to the module as ``mask``, so
    padded positions never reach attention or pooling."""
    if loss != "crossentropy":
        raise NotImplementedError(f"loss {loss!r} (reference parity: crossentropy only)")
    sites = getattr(module, "noise_sites", lambda batch: {})

    def cast(t: torch.Tensor) -> torch.Tensor:
        if compute_dtype is None or not t.is_floating_point():
            return t
        return t.to(compute_dtype)

    def forward(params, x, noise):
        kwargs = {"noise": noise} if noise else {}
        if pad_id is not None:
            kwargs["mask"] = x != pad_id
        return functional_call(module, {n: cast(p) for n, p in params.items()}, (cast(x),), kwargs)

    def train_loss_fn(params, x, y, noise=None):
        if not noise and sites(x.shape[0]):
            raise ValueError(
                f"{type(module).__name__} draws {sorted(sites(x.shape[0]))} in "
                "training; pass their keep-masks as noise"
            )
        logits = forward(params, x, noise)
        top1 = (logits.argmax(dim=-1) == y).to(torch.float32).mean()
        return cross_entropy(logits, y), {"top1": top1}

    def eval_logits_fn(params, x):
        return forward(params, x, None)

    template = {n: p.detach() for n, p in module.named_parameters()}
    return ModelSpec(
        module=module,
        init=module.init_params,
        train_loss_fn=train_loss_fn,
        eval_logits_fn=eval_logits_fn,
        layout=make_layout(template, module.jax_paths()),
        param_count=flat_dim(template),
        noise_sites=sites,
        rebuild_ok=True,
    )


def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal(stddev)``: ``std`` times a standard normal
    truncated at +-2, not rescaled."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense kernel init (``lecun_normal``: variance
    ``1/fan_in``, truncated at two standard deviations, rescaled so the
    truncated draw keeps that variance)."""
    return trunc_normal_(t, (1.0 / fan_in) ** 0.5 / 0.87962566103423978, generator)


def kaiming_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``kaiming_normal``: as :func:`lecun_normal_` with variance
    ``2/fan_in``."""
    return trunc_normal_(t, (2.0 / fan_in) ** 0.5 / 0.87962566103423978, generator)


def params_from_jax(tree: Dict[str, Any], layout: FlatLayout) -> Params:
    """The JAX package's params (nested dict of arrays, flax layout) as this
    package's params dict (float32 CPU tensors, torch layout)."""
    out = {}
    for leaf in layout.leaves:
        node = tree
        for key in leaf.jax_path:
            node = node[key]
        arr = np.asarray(node, dtype=np.float32)
        t = torch.from_numpy(np.array(arr.transpose(leaf.perm) if leaf.perm else arr, order="C"))
        if tuple(t.shape) != leaf.shape:
            raise ValueError(f"{'/'.join(leaf.jax_path)}: shape {arr.shape} does not fit {leaf.shape}")
        out[leaf.name] = t
    return out


def state_from_jax(tree: Any) -> Any:
    """The JAX package's cross-round state (a fault model's straggler
    buffer, a stateful aggregator's state: a pytree of dicts, lists and
    tuples of arrays) as this package's: the same nesting, each array a CPU
    tensor of its dtype. ``[K, D]`` leaves keep their order, the flat order
    of the update matrix that both packages share."""
    if isinstance(tree, dict):
        return {k: state_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_jax(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def params_to_jax(params: Params, layout: FlatLayout) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: a nested dict of numpy arrays in
    flax layout."""
    tree: Dict[str, Any] = {}
    for leaf in layout.leaves:
        arr = params[leaf.name].detach().cpu().numpy()
        node = tree
        for key in leaf.jax_path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.jax_path[-1]] = np.ascontiguousarray(arr.transpose(leaf.inverse) if leaf.perm else arr)
    return tree
