"""Checkpoint and resume of the federated training state.

Counterpart: ``blades_tpu/utils/checkpoint.py``. The whole
:class:`~blades_tpu_torch.core.RoundState` (global params, server and
stacked client optimizer state, aggregator, attack, fault and async state,
the round index) is one pytree (``torch.utils._pytree``), written as one
``.npz``: every leaf as ``leaf_<i>``, with ``__treedef__`` (the tree's
structure as text), ``__num_leaves__`` and ``__kinds__`` (each leaf's
torch dtype name, or ``int``/``float``/``bool``/``None`` for host values).
numpy has no bfloat16: a bf16 tensor is saved as its int16 bits and
restored bit for bit. Every generator of a round is a pure function of
(seed, round, purpose) (``utils/rng.py``), so the state is all a resumed
run needs to continue bit for bit.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

# ``BLADES_RESUME=1`` makes ``Simulator.run`` resume; defined beside the
# other supervision variables
from blades_tpu_torch.supervision.heartbeat import RESUME_ENV  # noqa: F401

_HOST_KINDS = {int: "int", float: "float", bool: "bool"}


def checkpoint_file(path: str) -> str:
    """The on-disk filename for ``path`` (``.npz`` appended to a path
    without it, as ``np.savez`` does)."""
    return path if path.endswith(".npz") else path + ".npz"


def _kind(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if leaf is None:
        return "None"
    if type(leaf) in _HOST_KINDS:
        return _HOST_KINDS[type(leaf)]
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(0 if leaf is None else leaf)


def save_state(path: str, state: Any) -> None:
    """Write the pytree ``state`` to ``checkpoint_file(path)``.

    Atomic: the archive is written to ``<path>.tmp`` and moved into place
    with ``os.replace``, so a process killed mid-save (the crash autosave
    is such a save) never leaves a torn file at the checkpoint path; a
    failed save removes its ``.tmp`` and leaves the previous checkpoint."""
    path = checkpoint_file(path)
    flat, spec = tree_flatten(state)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(flat)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                __treedef__=np.frombuffer(str(spec).encode(), np.uint8),
                __num_leaves__=np.asarray(len(flat)),
                __kinds__=np.asarray([_kind(x) for x in flat]),
                **arrays,
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _torn(fname: str, err: Exception) -> ValueError:
    return ValueError(f"checkpoint {fname} is corrupt or unreadable "
                      f"(truncated/torn write?): {type(err).__name__}: {err}")


def _leaf(arr: np.ndarray, kind: str, like, i: int):
    """Saved leaf ``i`` as ``like``'s kind of value, checked against it."""
    if not isinstance(like, torch.Tensor):
        if kind != _kind(like):
            raise ValueError(f"checkpoint leaf {i} is {kind}, expected {_kind(like)} "
                             "— incompatible config?")
        return None if like is None else type(like)(arr.item())
    if kind != _kind(like):
        raise ValueError(f"checkpoint leaf {i} dtype {kind} != expected {_kind(like)} "
                         "— incompatible config?")
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {i} shape {tuple(arr.shape)} != expected "
                         f"{tuple(like.shape)} — incompatible config?")
    # an owned copy on like's device, never a view of the archive's buffer:
    # a captured round writes its state back in place
    t = torch.from_numpy(np.array(arr, copy=True))
    if kind == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def restore_state(path: str, like: Any) -> Any:
    """The pytree saved at ``path`` by :func:`save_state`, shaped as
    ``like`` (e.g. a freshly built ``RoundState``): the saved structure,
    leaf count, kinds, shapes and dtypes must match it, else a
    ``ValueError`` says which. A truncated or unreadable archive raises a
    ``ValueError`` naming the file. Tensors land on ``like``'s devices as
    owned copies; host leaves (``round_idx``) come back as Python values."""
    fname = checkpoint_file(path)
    flat_like, spec = tree_flatten(like)
    try:
        z = np.load(fname, allow_pickle=False)
    except Exception as err:  # noqa: BLE001 - BadZipFile/OSError/ValueError on a torn file
        raise _torn(fname, err) from err
    with z:
        try:
            saved_n = int(z["__num_leaves__"])
            saved_spec = bytes(z["__treedef__"]).decode()
            kinds = [str(k) for k in z["__kinds__"]]
        except Exception as err:  # noqa: BLE001 - a member read on a torn archive
            raise _torn(fname, err) from err
        if saved_n != len(flat_like):
            raise ValueError(
                f"checkpoint has {saved_n} leaves but the current engine state has "
                f"{len(flat_like)} — incompatible config (e.g. persist/aggregator/"
                "attack/fault model mismatch)?")
        if saved_spec != str(spec):
            raise ValueError(
                "checkpoint tree structure differs from the current engine state:\n"
                f"  saved:   {saved_spec}\n  current: {spec}")
        flat = []
        for i, old in enumerate(flat_like):
            try:
                arr = z[f"leaf_{i}"]
            except Exception as err:  # noqa: BLE001 - zlib/zipfile on a torn member
                raise _torn(fname, err) from err
            flat.append(_leaf(arr, kinds[i], old, i))
    return tree_unflatten(flat, spec)
