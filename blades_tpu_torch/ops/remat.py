"""Rematerialization of a client's loss: the forward keeps no activations
and the backward recomputes them.

Counterpart: ``jax.checkpoint`` around each client's clamped loss in
``blades_tpu/core/engine.py:599-607`` (``RoundEngine(remat=True)``). The
port wraps the same function at the same granularity, the whole clamped
loss of one local step.

``torch.utils.checkpoint`` cannot serve here: ``torch.func.grad`` refuses
its non-reentrant form (saved-tensor hooks) and its reentrant form (an
``autograd.Function`` without ``setup_context``). :func:`remat` is an
``autograd.Function`` with ``setup_context`` and a generated vmap rule, so
it composes with the engine's ``vmap(grad_and_value(...))``: its forward
computes the loss and its aux from the inputs and saves only the inputs;
its backward runs the forward again under ``torch.func.vjp`` and returns
the vector-Jacobian product. The dropout and DropPath keep-masks are
inputs (drawn before training, ``RoundEngine._draw_noise``), so the
recomputed forward sees the masks the first one saw, and the gradient is
the one without remat.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten


class _AuxSpec:
    """Where the forward leaves the aux's tree structure (an object, not a
    container that the transforms would flatten)."""

    spec = None


class _Remat(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, spec, box, *leaves):
        loss, aux = fn(*tree_unflatten(list(leaves), spec))
        aux_leaves, box.spec = tree_flatten(aux)
        return (loss, *aux_leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, spec, _, *leaves = inputs
        ctx.fn, ctx.spec = fn, spec
        ctx.save_for_backward(*leaves)  # the inputs only, no activation
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, grad_loss, *_):
        leaves = list(ctx.saved_tensors)
        wrt = [i for i, need in enumerate(ctx.needs_input_grad[3:])
               if need and leaves[i].is_floating_point()]

        def loss_of(*diff):
            args = list(leaves)
            for i, t in zip(wrt, diff):
                args[i] = t
            return ctx.fn(*tree_unflatten(args, ctx.spec))[0]

        _, vjp_fn = torch.func.vjp(loss_of, *(leaves[i] for i in wrt))
        grads = dict(zip(wrt, vjp_fn(grad_loss)))
        return (None, None, None, *(grads.get(i) for i in range(len(leaves))))


def remat(fn: Callable) -> Callable:
    """``fn(*args) -> (loss, aux)`` whose forward saves only its inputs and
    whose backward recomputes it (``jax.checkpoint(fn)``); ``args`` and
    ``aux`` are pytrees of tensors."""

    def wrapped(*args):
        leaves, spec = tree_flatten(args)
        box = _AuxSpec()
        out = _Remat.apply(fn, spec, box, *leaves)
        return out[0], tree_unflatten(list(out[1:]), box.spec)

    return wrapped
