"""Shared model plumbing: an ``nn.Module`` -> pure-function adapter.

Counterpart: ``blades_tpu/models/common.py:20-107`` (``cross_entropy``,
``ModelSpec``, ``build_fns``). The round engine consumes
``train_loss_fn(params, x, y, generator) -> (loss, {"top1": ...})`` and
``eval_logits_fn(params, x)``; here both call the module through
``torch.func.functional_call`` with a params dict, so the engine can take
per-client gradients with ``torch.func.vmap``. The ``compute_dtype`` (bf16)
option of the JAX package comes with CCT-2 (``ROADMAP.md`` queue A, slice 2).

:func:`params_from_jax` / :func:`params_to_jax` carry parameters between the
two packages: the JAX side as a nested dict of numpy arrays in flax layout
(a Dense kernel is ``[in, out]``), this side as a dict of tensors in torch
layout (``nn.Linear.weight`` is ``[out, in]``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from blades_tpu_torch.ops.pytree import FlatLayout, Params, flat_dim, make_layout


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; takes logits or log-probs alike
    (log_softmax is idempotent, so the MLP's log_softmax output gives the
    same loss as its logits would)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, y.long()[..., None]).mean()


@dataclasses.dataclass
class ModelSpec:
    """The pure functions the engine needs, the params' flat layout, and
    ``init(generator) -> params`` (CPU tensors, so one seed gives the same
    params whatever device the run uses)."""

    module: nn.Module
    init: Callable[[torch.Generator], Params]
    train_loss_fn: Callable
    eval_logits_fn: Callable
    layout: FlatLayout
    param_count: Optional[int] = None


def build_fns(module: nn.Module, loss: str = "crossentropy") -> ModelSpec:
    """Adapt a module that defines ``init_params(generator)`` and
    ``jax_paths()`` (its map ``torch name -> (flax path, transposed)``) to
    the engine's interface."""
    if loss != "crossentropy":
        raise NotImplementedError(f"loss {loss!r} (reference parity: crossentropy only)")

    def train_loss_fn(params, x, y, generator=None):
        # no model ported so far draws randomness in training; the generator
        # is the slot DropPath/dropout take with CCT-2
        logits = functional_call(module, params, (x,))
        top1 = (logits.argmax(dim=-1) == y).to(torch.float32).mean()
        return cross_entropy(logits, y), {"top1": top1}

    def eval_logits_fn(params, x):
        return functional_call(module, params, (x,))

    template = {n: p.detach() for n, p in module.named_parameters()}
    return ModelSpec(
        module=module,
        init=module.init_params,
        train_loss_fn=train_loss_fn,
        eval_logits_fn=eval_logits_fn,
        layout=make_layout(template, module.jax_paths()),
        param_count=flat_dim(template),
    )


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense kernel init (``lecun_normal``: variance
    ``1/fan_in``, truncated at two standard deviations, rescaled so the
    truncated draw keeps that variance)."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def params_from_jax(tree: Dict[str, Any], layout: FlatLayout) -> Params:
    """The JAX package's params (nested dict of arrays, flax layout) as this
    package's params dict (float32 CPU tensors, torch layout)."""
    out = {}
    for leaf in layout.leaves:
        node = tree
        for key in leaf.jax_path:
            node = node[key]
        arr = np.asarray(node, dtype=np.float32)
        t = torch.from_numpy(arr.T.copy() if leaf.transposed else arr.copy())
        if tuple(t.shape) != leaf.shape:
            raise ValueError(f"{'/'.join(leaf.jax_path)}: shape {arr.shape} does not fit {leaf.shape}")
        out[leaf.name] = t
    return out


def params_to_jax(params: Params, layout: FlatLayout) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: a nested dict of numpy arrays in
    flax layout."""
    tree: Dict[str, Any] = {}
    for leaf in layout.leaves:
        arr = params[leaf.name].detach().cpu().numpy()
        node = tree
        for key in leaf.jax_path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.jax_path[-1]] = np.ascontiguousarray(arr.T if leaf.transposed else arr)
    return tree
