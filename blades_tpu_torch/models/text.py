"""Text Compact Transformers (TextCCT / TextCVT / TextViT / Transformer-Lite).

Counterpart: ``blades_tpu/models/text.py`` — ``Embedder`` (:40-56),
``TextTokenizer`` (:59-127, the mask's ``_forward_mask`` :99-119, the length
formula :121-127), ``MaskedAttention`` (:130-187), the encoder layer
(:190-217), ``TextCCT`` (:220-333), the factory grid ``_GRID`` over
``text_{cct,cvt,vit,transformer}_{2,4,6}`` (:338-404, :441-450) and
``long_text_transformer`` (:407-438). The flagship ``text_cct_2`` at its
defaults (100,000 words of width 300, 64 tokens) has D = 30,352,643, the
word table alone 30,000,000 of them.

Tokens come in as ``[B, L]`` int ids with an optional ``[B, L]`` bool
validity mask (``build_fns(pad_id=...)`` derives it as ``x != pad_id``).
Padded positions are zeroed after the embedding and after the tokenizer;
the mask follows the tokenizer as a ones-kernel ``conv1d`` and the same
max-pool of the float mask, thresholded ``> 0``; attention logits whose
query or key is padding, and the seq-pool weights of padding, are filled
with ``NEG_INF = -1e9`` before the softmax (not -inf: a row with no valid
key stays finite and uniform, as in JAX; an all-padding row, which a client
left empty by a Dirichlet split trains on, gives finite logits). The
class-token mode extends the mask with an always-valid slot.

What has to match flax beyond the CCT's rules (``models/cct.py``): the word
table is a plain ``nn.Embedding`` (``normal(1.0)``, no ``padding_idx``,
which would change the init and row 0's gradient, and no sparse gradient,
which the flat ``[K, D]`` layout cannot hold); the tokenizer's ``conv1d``
spans the whole word width with no bias (``kaiming_normal``, fan_in =
k * width), its weight ``[C, E, k]`` against flax's ``[k, E, C]``
(``ops/pytree.py:CONV1D``); the default ``stride = max(1, k // 2 - 1)`` and
``padding = max(1, k // 2)``. The learnable positional table is sized at
construction from ``seq_len``, the token count of the store's rows. The
sine table is cast to the stream's dtype, as the image CCT's is; the JAX
package adds it in float32, which under ``compute_dtype=bfloat16`` promotes
the JAX encoder to float32 (bf16 is held to the JAX package within a
relative L2 error of 2e-2, ``tests/test_torch_text.py``).

The attention, conv and embedding are stock torch ops, as the JAX package
left them to XLA.

With ``ring_mesh`` (a ``parallel/mesh.py:Mesh`` with the axis
``ring_axis``) every encoder layer's attention runs sequence-parallel
(JAX ``MaskedAttention``, :130-187): the K/V ring
(``seq_parallel="ring"``, ``ops/ring_attention.py``) or the head-parallel
all-to-all (``"ulysses"``, ``ops/ulysses.py``); any other schedule raises
``ValueError``. The JAX package's two stated deviations hold (:134-143):
no attention dropout on that path (its keep-mask is not drawn either), and
only the key side of the mask (the rows of padded queries differ, and
every consumer masks them out).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from blades_tpu_torch.models.cct import (
    LN_EPS,
    NEG_INF,
    Masks,
    TransformerEncoderLayer,
    _mask,
    encoder_paths,
    flax_init,
    sinusoidal_embedding,
)
from blades_tpu_torch.models.common import NoiseSites, dropout
from blades_tpu_torch.ops.pytree import CONV1D


class Embedder(nn.Module):
    """Word embedding table; padded positions (mask False) are zeroed."""

    def __init__(self, vocab_size: int = 100_000, word_embedding_dim: int = 300):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, word_embedding_dim)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embedding(tokens)
        return x if mask is None else x * mask[..., None].to(x.dtype)


class TextTokenizer(nn.Module):
    """A 1-D conv over the sequence spanning the whole embedding width,
    optional ReLU, optional max-pool (-inf padding, as flax's); the mask
    rides along through the same receptive fields."""

    def __init__(self, kernel_size: int, stride: int, padding: int, word_embedding_dim: int,
                 n_output_channels: int = 128, max_pool: bool = True, use_act: bool = True,
                 pooling_kernel_size: int = 3, pooling_stride: int = 2,
                 pooling_padding: int = 1):
        super().__init__()
        self.conv = nn.Conv1d(word_embedding_dim, n_output_channels, kernel_size, stride,
                              padding, bias=False)
        self.max_pool, self.use_act = max_pool, use_act
        self.pool = (pooling_kernel_size, pooling_stride, pooling_padding)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        x = self.conv(x.transpose(1, 2))  # [B, L, E] -> [B, C, L']
        if self.use_act:
            x = F.relu(x)
        if self.max_pool:
            x = F.max_pool1d(x, *self.pool)
        x = x.transpose(1, 2)
        if mask is not None:
            mask = self.forward_mask(mask)
            x = x * mask[..., None].to(x.dtype)
        return x, mask

    def forward_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """A token survives if any source position in its receptive field
        was valid: the float mask through a ones-kernel conv1d and the same
        max-pool, ``> 0``."""
        k, = self.conv.kernel_size
        ones = torch.ones(1, 1, k, device=mask.device)
        m = F.conv1d(mask.to(torch.float32)[:, None], ones, stride=self.conv.stride,
                     padding=self.conv.padding)
        if self.max_pool:
            m = F.max_pool1d(m, *self.pool)
        return m[:, 0] > 0

    def seq_len(self, seq_len: int) -> int:
        """Tokens out of ``seq_len`` positions in."""
        (k,), (s,), (p,) = self.conv.kernel_size, self.conv.stride, self.conv.padding
        n = (seq_len + 2 * p - k) // s + 1
        if self.max_pool:
            pk, ps, pp = self.pool
            n = (n + 2 * pp - pk) // ps + 1
        return n


class TextCCT(nn.Module):
    """The four text families in one module:

    - ``text_cct_*``: conv tokenizer (ReLU + max-pool) + seq-pool
    - ``text_cvt_*``: patchify tokenizer (no act/pool) + seq-pool
    - ``text_vit_*``: patchify tokenizer + class token
    - ``text_transformer_*``: no tokenizer (word embeddings straight into
      the encoder) + class token
    """

    def __init__(self, num_classes: int = 2, seq_len: int = 64, vocab_size: int = 100_000,
                 word_embedding_dim: int = 300, embedding_dim: int = 128, num_layers: int = 2,
                 num_heads: int = 2, mlp_ratio: float = 1.0, kernel_size: int = 4,
                 stride: Optional[int] = None, padding: Optional[int] = None,
                 use_tokenizer: bool = True, max_pool: bool = True, use_act: bool = True,
                 seq_pool: bool = True, dropout: float = 0.0, attention_dropout: float = 0.1,
                 stochastic_depth: float = 0.1, positional_embedding: str = "sine",
                 ring_mesh=None, ring_axis: str = "seq", seq_parallel: str = "ring"):
        super().__init__()
        sp_attn = None
        if ring_mesh is not None:
            if seq_parallel == "ulysses":
                from blades_tpu_torch.ops.ulysses import ulysses_attention as sp_attn
            elif seq_parallel == "ring":
                from blades_tpu_torch.ops.ring_attention import ring_attention as sp_attn
            else:  # a typo must not silently run the wrong schedule
                raise ValueError(f"seq_parallel must be 'ring' or 'ulysses', got "
                                 f"{seq_parallel!r}")
        self.ring_mesh, self.ring_axis, self.seq_parallel = ring_mesh, ring_axis, seq_parallel
        if positional_embedding not in ("learnable", "sine", "none"):
            raise ValueError(f"positional_embedding {positional_embedding!r}")
        self.seq_len_in = int(seq_len)
        self.embedder = Embedder(vocab_size, word_embedding_dim)
        self.tokenizer = None
        width, n = word_embedding_dim, self.seq_len_in
        if use_tokenizer:
            stride = stride if stride is not None else max(1, kernel_size // 2 - 1)
            padding = padding if padding is not None else max(1, kernel_size // 2)
            self.tokenizer = TextTokenizer(kernel_size, stride, padding, word_embedding_dim,
                                           embedding_dim, max_pool=max_pool, use_act=use_act)
            width, n = embedding_dim, self.tokenizer.seq_len(n)
        self.class_emb = None if seq_pool else nn.Parameter(torch.zeros(1, 1, width))
        self.seq_len = n + (not seq_pool)  # tokens the encoder sees
        self.embedding_dim = width
        self.seq_pool = seq_pool
        self.positional = positional_embedding
        self.dropout = dropout
        self.positional_emb = (
            nn.Parameter(torch.zeros(1, self.seq_len, width))
            if positional_embedding == "learnable" else None
        )
        dpr = [stochastic_depth * i / max(num_layers - 1, 1) for i in range(num_layers)]
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(width, num_heads, int(width * mlp_ratio), dropout,
                                    attention_dropout, rate)
            for rate in dpr
        )
        if sp_attn is not None:
            for layer in self.layers:
                layer.self_attn.seq_parallel = (sp_attn, ring_mesh, ring_axis)
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.attention_pool = nn.Linear(width, 1) if seq_pool else None
        self.fc = nn.Linear(width, num_classes)

    def noise_sites(self, batch: int) -> NoiseSites:
        n, c = self.seq_len, self.embedding_dim
        sites = {"emb": ((batch, n, c), 1.0 - self.dropout)} if self.dropout else {}
        for i, layer in enumerate(self.layers):
            sites.update({f"layers.{i}.{k}": v for k, v in layer.noise_sites(batch, n).items()})
        return sites

    def forward(self, tokens: torch.Tensor, noise: Masks = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tokens.shape[-1] != self.seq_len_in:
            raise ValueError(f"input length {tokens.shape[-1]} != configured seq_len "
                             f"{self.seq_len_in}")
        x = self.embedder(tokens, mask)
        if self.tokenizer is not None:
            x, mask = self.tokenizer(x, mask)
        if self.class_emb is not None:
            b = x.shape[0]
            x = torch.cat([self.class_emb.expand(b, -1, -1), x], dim=1)
            if mask is not None:
                valid = torch.ones(b, 1, dtype=torch.bool, device=mask.device)
                mask = torch.cat([valid, mask], dim=1)
        if self.positional_emb is not None:
            x = x + self.positional_emb
        elif self.positional == "sine":
            x = x + sinusoidal_embedding(x.shape[1], x.shape[2], x.device).to(x.dtype)
        x = dropout(x, _mask(noise, "emb", self.dropout), self.dropout)
        for i, layer in enumerate(self.layers):
            x = layer(x, noise, f"layers.{i}.", mask)
        x = self.norm(x)
        if self.seq_pool:
            w = self.attention_pool(x)  # [B, N, 1]
            if mask is not None:
                w = torch.where(mask[..., None], w, NEG_INF)
            x = torch.einsum("bnl,bnc->bc", w.softmax(dim=1), x)
        else:
            x = x[:, 0]
        return self.fc(x)

    # -- the flax tree --------------------------------------------------------

    def jax_paths(self) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]]:
        """torch name -> (flax path, perm)."""
        paths = {"embedder.embedding.weight": (("Embedder_0", "Embed_0", "embedding"), ())}
        if self.tokenizer is not None:
            paths["tokenizer.conv.weight"] = (("TextTokenizer_0", "Conv_0", "kernel"), CONV1D)
        return {**paths, **encoder_paths(self, "MaskedTransformerEncoderLayer",
                                         "MaskedAttention_0")}

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return flax_init(self, generator)


# -- factories (reference text/{cct,cvt,vit,transformer}.py grids) ------------

_GRID = {2: (2, 2, 1.0, 128), 4: (4, 2, 1.0, 128), 6: (6, 4, 2.0, 256)}


def _text(kind: str, depth: int, num_classes: int = 2, **kw) -> TextCCT:
    layers, heads, ratio, dim = _GRID[depth]
    cfg = dict(num_classes=num_classes, num_layers=layers, num_heads=heads, mlp_ratio=ratio,
               embedding_dim=dim)
    if kind == "cct":
        cfg.update(kernel_size=4, max_pool=True, use_act=True, seq_pool=True)
    elif kind == "cvt":
        # patchify: kernel = stride = patch size, no pad/act/pool
        cfg.update(kernel_size=4, stride=4, padding=0, max_pool=False, use_act=False,
                   seq_pool=True)
    elif kind == "vit":
        cfg.update(kernel_size=4, stride=4, padding=0, max_pool=False, use_act=False,
                   seq_pool=False)
    elif kind == "transformer":
        # no tokenizer: the encoder's width is the word embedding's
        cfg.update(use_tokenizer=False, seq_pool=False)
        cfg.pop("embedding_dim")
    cfg.update(kw)
    return TextCCT(**cfg)


def text_cct_2(num_classes: int = 2, **kw) -> TextCCT:
    return _text("cct", 2, num_classes, **kw)


def text_cct_4(num_classes: int = 2, **kw) -> TextCCT:
    return _text("cct", 4, num_classes, **kw)


def text_cct_6(num_classes: int = 2, **kw) -> TextCCT:
    return _text("cct", 6, num_classes, **kw)


def text_cvt_2(num_classes: int = 2, **kw) -> TextCCT:
    return _text("cvt", 2, num_classes, **kw)


def text_cvt_4(num_classes: int = 2, **kw) -> TextCCT:
    return _text("cvt", 4, num_classes, **kw)


def text_cvt_6(num_classes: int = 2, **kw) -> TextCCT:
    return _text("cvt", 6, num_classes, **kw)


def text_vit_2(num_classes: int = 2, **kw) -> TextCCT:
    return _text("vit", 2, num_classes, **kw)


def text_vit_4(num_classes: int = 2, **kw) -> TextCCT:
    return _text("vit", 4, num_classes, **kw)


def text_vit_6(num_classes: int = 2, **kw) -> TextCCT:
    return _text("vit", 6, num_classes, **kw)


def text_transformer_2(num_classes: int = 2, **kw) -> TextCCT:
    return _text("transformer", 2, num_classes, **kw)


def text_transformer_4(num_classes: int = 2, **kw) -> TextCCT:
    return _text("transformer", 4, num_classes, **kw)


def text_transformer_6(num_classes: int = 2, **kw) -> TextCCT:
    return _text("transformer", 6, num_classes, **kw)


def long_text_transformer(num_classes: int = 2, mesh=None, axis_name: str = "seq",
                          depth: int = 2, **kw) -> TextCCT:
    """Long-sequence text classifier: tokenizer-free, seq-pool head (no
    class token, which would break the N-divisibility the split needs).
    With a ``mesh`` the token axis is split over ``mesh[axis_name]``: the
    K/V ring by default, ``seq_parallel="ulysses"`` for the head-parallel
    all-to-all (heads divisible by the axis size); ``mesh=None`` is the
    dense model. ``seq_len`` (a keyword of :class:`TextCCT`) is the input
    length."""
    layers, heads, ratio, _ = _GRID[depth]
    cfg = dict(num_classes=num_classes, num_layers=layers, num_heads=heads, mlp_ratio=ratio,
               use_tokenizer=False, seq_pool=True, ring_mesh=mesh, ring_axis=axis_name)
    cfg.update(kw)
    return TextCCT(**cfg)
