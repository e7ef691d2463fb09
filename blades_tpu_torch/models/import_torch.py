"""Torch-checkpoint import for the Compact-Transformer zoo.

Counterpart: ``blades_tpu/models/import_torch.py`` (``resize_pos_embed``
:45-73, ``torch_cct_to_flax`` :76-230, ``load_torch_checkpoint`` :240-248).
The reference ships pretrained CCT weights as torch ``state_dict`` files
(``src/blades/models/cifar10/cctnets/cct.py:13-30,90-118``). This module
maps such a state dict, loaded from a local ``.pth``, onto the params dict
of :class:`blades_tpu_torch.models.cct.CCT`. The port keeps torch's layouts
(Linear ``[out, in]``, Conv OIHW, LayerNorm ``weight``/``bias``), so only
the names change:

- ``tokenizer.conv_layers.{i}.0.{weight,bias}`` -> ``tokenizer.convs.{i}.*``
- ``classifier.positional_emb`` / ``class_emb`` -> ``positional_emb`` /
  ``class_emb``
- ``classifier.blocks.{i}.{pre_norm,self_attn.qkv,self_attn.proj,norm1,
  linear1,linear2}`` -> ``layers.{i}.*``
- ``classifier.norm`` / ``attention_pool`` / ``fc`` -> ``norm`` /
  ``attention_pool`` / ``fc``

The JAX package's rules are kept: a sine model's stored
``classifier.positional_emb`` is skipped; ``pe_resize`` interpolates a
positional grid of another resolution (``pe_check``); ``fc_tolerant`` keeps
the template's fresh head when the class count differs (``fc_check``); an
unknown key, a leaf the state dict leaves unfilled or a shape mismatch
raises ``ValueError``.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Dict, Mapping

import torch
import torch.nn.functional as F

logger = logging.getLogger("debug")

_VARIANT = "checkpoint is for a different model variant (depth/width/pooling)?"


def resize_pos_embed(posemb: torch.Tensor, new_len: int, num_tokens: int = 0) -> torch.Tensor:
    """Bilinearly rescale a learned positional-embedding grid to a new token
    count (reference ``resize_pos_embed``/``pe_check``,
    ``cctnets/utils/helpers.py:10-36``); the first ``num_tokens``
    class-token embeddings pass through untouched.

    ``posemb``: ``[1, n_old, d]`` -> ``[1, new_len, d]``. The JAX package
    resizes with ``jax.image.resize(method="bilinear")``, which antialiases
    when it downsamples; ``F.interpolate`` matches it only with
    ``antialias=True`` (without, an 8x8 -> 4x4 grid is 0.5 off)."""
    posemb = torch.as_tensor(posemb, dtype=torch.float32)
    tok, grid = posemb[:, :num_tokens], posemb[0, num_tokens:]
    gs_old = int(math.sqrt(grid.shape[0]))
    gs_new = int(math.sqrt(new_len - num_tokens))
    if gs_old * gs_old != grid.shape[0] or gs_new * gs_new != new_len - num_tokens:
        raise ValueError(
            f"positional-embedding lengths {grid.shape[0]} -> {new_len - num_tokens} "
            "are not square grids; cannot interpolate"
        )
    grid = grid.reshape(1, gs_old, gs_old, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gs_new, gs_new), mode="bilinear", align_corners=False,
                         antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(1, gs_new * gs_new, -1)
    return torch.cat([tok, grid], dim=1)


def _port_name(key: str) -> str:
    """The port's parameter name of a reference state-dict key."""
    parts = key.split(".")
    if len(parts) < 2:
        raise ValueError(f"unrecognized state_dict key {key!r} (not a CCT-zoo state_dict? "
                         "unwrap the checkpoint's 'state_dict' entry)")
    leaf = "weight" if parts[-1] == "weight" else "bias"
    if parts[0] == "tokenizer":
        return f"tokenizer.convs.{int(parts[2])}.{leaf}"
    if key in ("classifier.positional_emb", "classifier.class_emb"):
        return parts[1]
    if parts[1] == "blocks":
        i, sub = int(parts[2]), parts[3]
        if sub == "self_attn":
            sub = "self_attn." + ("qkv" if parts[4] == "qkv" else "proj")
        elif sub not in ("pre_norm", "norm1", "linear1", "linear2"):
            raise ValueError(f"unrecognized block entry {key!r}")
        return f"layers.{i}.{sub}.{leaf}"
    if parts[1] in ("norm", "attention_pool", "fc"):
        return f"{parts[1]}.{leaf}"
    raise ValueError(f"unrecognized state_dict key {key!r}")


def torch_cct_to_params(
    state_dict: Mapping[str, Any],
    params_template: Dict[str, torch.Tensor],
    pe_resize: bool = True,
    fc_tolerant: bool = True,
) -> Dict[str, torch.Tensor]:
    """A reference-CCT state dict as the port's params dict (float32 CPU
    tensors). ``params_template``: a fresh params dict of the matching
    variant (``spec.init``); every leaf must be covered by the state dict
    and every key must land on a leaf, or a ``ValueError`` explains the
    mismatch. ``pe_resize`` and ``fc_tolerant``: as the reference's loader
    (``cctnets/cct.py:110-116``); pass False for strict shape errors."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        name = _port_name(key)
        if name == "positional_emb" and "positional_emb" not in params_template:
            # the reference's *_sine variants store their fixed table as a
            # parameter; a sine model here computes it
            continue
        if name not in params_template:
            raise ValueError(f"{key!r} -> {name!r} missing in template — {_VARIANT}")
        out[name] = torch.as_tensor(value).detach().to("cpu", torch.float32).clone()

    pe, tmpl_pe = out.get("positional_emb"), params_template.get("positional_emb")
    if pe_resize and pe is not None and tuple(pe.shape) != tuple(tmpl_pe.shape):
        num_tokens = 1 if "class_emb" in params_template else 0
        out["positional_emb"] = resize_pos_embed(pe, int(tmpl_pe.shape[1]), num_tokens)
        logger.info("resized positional embedding %s -> %s (pe_check)", tuple(pe.shape),
                    tuple(tmpl_pe.shape))

    if fc_tolerant:
        for leaf in ("fc.weight", "fc.bias"):
            got, want = out.get(leaf), params_template.get(leaf)
            if got is not None and want is not None and got.shape != want.shape:
                logger.warning("Removing %s, number of classes has changed.", leaf)
                out[leaf] = want.detach().to("cpu", torch.float32).clone()

    for name, want in params_template.items():
        got = out.get(name)
        if got is None:
            raise ValueError(f"state_dict left param {name!r} unfilled")
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {name!r}: checkpoint {tuple(got.shape)} vs "
                             f"model {tuple(want.shape)}")
    return {name: out[name] for name in params_template}


def to_reference_state_dict(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse name map: a CCT params dict of the port as the
    reference's state dict (``classifier.*``, ``tokenizer.conv_layers.*``),
    which :func:`torch_cct_to_params` reads back unchanged."""
    def ref_name(name: str) -> str:
        m = re.fullmatch(r"tokenizer\.convs\.(\d+)\.(\w+)", name)
        if m:
            return f"tokenizer.conv_layers.{m[1]}.0.{m[2]}"
        return "classifier." + name.replace("layers.", "blocks.", 1)

    return {ref_name(n): t.detach().cpu().clone() for n, t in params.items()}


def load_torch_checkpoint(path: str, params_template: Dict[str, torch.Tensor]):
    """Load a reference ``.pth`` checkpoint (tensors only) and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return torch_cct_to_params(sd, params_template)
