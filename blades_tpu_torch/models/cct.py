"""Compact Transformers (CCT / CVT / ViT-Lite).

Counterpart: ``blades_tpu/models/cct.py`` — ``Tokenizer`` (:32-83),
``Attention`` (:86-107), ``TransformerEncoderLayer`` (:110-136),
``sinusoidal_embedding`` (:139-144), ``CCT`` (:147-244), the six factories
(:247-345) and ``CCTNet``. The flagship is ``cct_2_3x2_32``: a two-conv
tokenizer (3->64->128 channels, 3x3, ReLU, 3x3/2 max-pool), two pre-norm
encoder layers of width 128 with 2 heads, sequence pooling; D = 283,723.

The module takes NHWC input, as the flax model does, and keeps its weights
in torch's layout (Dense ``[out, in]``, Conv OIHW); :meth:`CCT.jax_paths`
maps each onto its flax leaf and the permutation between the two
(``ops/pytree.py``). What has to match flax exactly: LayerNorm's eps 1e-6,
the tanh form of GELU, the qkv split as ``(b, n, 3, heads, head_dim)``, the
residual wiring of :class:`TransformerEncoderLayer`, tokens in row-major
``(h, w)`` order, max-pool padded with -inf (torch's and flax's alike), and
the inits (``truncated_normal`` not rescaled, ``kaiming_normal`` rescaled).

Training randomness comes in as keep-masks (``models/common.py``): the
sites are listed by :meth:`CCT.noise_sites`; with the defaults of CCT-2
those are each layer's attention dropout (0.1, ``[B, heads, N, N]``) and
layer 1's two DropPaths (0.1, ``[B]``); layer 0's DropPath rate is 0 and
``dropout`` is 0, so they draw nothing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from blades_tpu_torch.models.common import (
    NoiseSites,
    drop_path,
    dropout,
    kaiming_normal_,
    trunc_normal_,
)
from blades_tpu_torch.ops.pytree import CONV2D, DENSE

LN_EPS = 1e-6  # flax nn.LayerNorm; torch defaults to 1e-5
Masks = Optional[Dict[str, torch.Tensor]]


def _dense_paths(prefix: str, path: Tuple[str, ...], bias: bool = True) -> dict:
    out = {f"{prefix}.weight": (path + ("kernel",), DENSE)}
    if bias:
        out[f"{prefix}.bias"] = (path + ("bias",), ())
    return out


def _norm_paths(prefix: str, path: Tuple[str, ...]) -> dict:
    return {f"{prefix}.weight": (path + ("scale",), ()), f"{prefix}.bias": (path + ("bias",), ())}


def _mask(noise: Masks, name: str, rate: float) -> Optional[torch.Tensor]:
    """The site's keep-mask; None in eval (no noise) and where the rate is 0
    (such a site draws nothing)."""
    return None if noise is None or rate == 0.0 else noise[name]


class Tokenizer(nn.Module):
    """Conv tokenizer: ``n_conv_layers`` convs, each optionally followed by
    ReLU and a 3x3/2 max-pool, flattened to ``[B, N, C]``."""

    def __init__(self, kernel_size: int, stride: int, padding: int, n_conv_layers: int = 1,
                 n_output_channels: int = 64, in_planes: int = 64, in_channels: int = 3,
                 max_pool: bool = True, use_act: bool = True, conv_bias: bool = False,
                 pooling_kernel_size: int = 3, pooling_stride: int = 2,
                 pooling_padding: int = 1):
        super().__init__()
        chans = [in_channels] + [in_planes] * (n_conv_layers - 1) + [n_output_channels]
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, kernel_size, stride, padding, bias=conv_bias)
            for a, b in zip(chans[:-1], chans[1:])
        )
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.max_pool, self.use_act = max_pool, use_act
        self.pool = (pooling_kernel_size, pooling_stride, pooling_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.convs:
            x = conv(x)
            if self.use_act:
                x = F.relu(x)
            if self.max_pool:
                x = F.max_pool2d(x, *self.pool)  # implicit -inf padding, as flax
        return x.flatten(2).transpose(1, 2)  # tokens in (h, w) row-major order

    def sequence_length(self, img_size: int) -> int:
        """Tokens of a square ``img_size`` image."""
        n = img_size
        k, s, p = self.pool
        for _ in self.convs:
            n = (n + 2 * self.padding - self.kernel_size) // self.stride + 1
            if self.max_pool:
                n = (n + 2 * p - k) // s + 1
        return n * n


class Attention(nn.Module):
    """MHSA: qkv without bias, projection with bias; attention dropout on
    the softmax, projection dropout on the output."""

    def __init__(self, dim: int, num_heads: int, attention_dropout: float = 0.1,
                 projection_dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.attention_dropout = attention_dropout
        self.projection_dropout = projection_dropout

    def noise_sites(self, batch: int, n: int) -> NoiseSites:
        sites = {"attn": ((batch, self.num_heads, n, n), 1.0 - self.attention_dropout),
                 "proj": ((batch, n, self.proj.out_features), 1.0 - self.projection_dropout)}
        return {k: v for k, v in sites.items() if v[1] < 1.0}

    def forward(self, x: torch.Tensor, noise: Masks = None, prefix: str = "") -> torch.Tensor:
        b, n, c = x.shape
        head_dim = c // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, N, H, Dh]
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (head_dim**-0.5)
        rate = self.attention_dropout
        attn = dropout(attn.softmax(dim=-1), _mask(noise, prefix + "attn", rate), rate)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        rate = self.projection_dropout
        return dropout(self.proj(out), _mask(noise, prefix + "proj", rate), rate)


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block with the reference's residual wiring: the attention
    residual, then LayerNorm, then an MLP residual onto the *normed*
    stream."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dropout: float = 0.1,
                 attention_dropout: float = 0.1, drop_path_rate: float = 0.1):
        super().__init__()
        self.pre_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.self_attn = Attention(d_model, nhead, attention_dropout, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.dropout = dropout
        self.drop_path_rate = drop_path_rate

    def noise_sites(self, batch: int, n: int) -> NoiseSites:
        d, f = self.linear1.in_features, self.linear1.out_features
        sites = {f"attn.{k}": v for k, v in self.self_attn.noise_sites(batch, n).items()}
        sites.update({"path1": ((batch,), 1.0 - self.drop_path_rate),
                      "drop1": ((batch, n, f), 1.0 - self.dropout),
                      "drop2": ((batch, n, d), 1.0 - self.dropout),
                      "path2": ((batch,), 1.0 - self.drop_path_rate)})
        return {k: v for k, v in sites.items() if v[1] < 1.0}

    def forward(self, x: torch.Tensor, noise: Masks = None, prefix: str = "") -> torch.Tensor:
        dp, drop = self.drop_path_rate, self.dropout
        h = self.self_attn(self.pre_norm(x), noise, prefix + "attn.")
        x = x + drop_path(h, _mask(noise, prefix + "path1", dp), dp)
        x = self.norm1(x)
        h = F.gelu(self.linear1(x), approximate="tanh")  # flax nn.gelu's default form
        h = dropout(h, _mask(noise, prefix + "drop1", drop), drop)
        h = dropout(self.linear2(h), _mask(noise, prefix + "drop2", drop), drop)
        return x + drop_path(h, _mask(noise, prefix + "path2", dp), dp)


def sinusoidal_embedding(n: int, dim: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device)[:, None]
    i = torch.arange(dim, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * (i // 2) / dim)
    return torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle))[None]


class CCT(nn.Module):
    """Compact Convolutional Transformer. ``seq_pool=True``: attention
    sequence pooling; ``False``: a class token (ViT-Lite). The tokenizer
    (conv stack or patchify) tells CCT from CVT and ViT-Lite."""

    def __init__(self, num_classes: int = 10, img_size: int = 32, in_channels: int = 3,
                 embedding_dim: int = 128, num_layers: int = 2, num_heads: int = 2,
                 mlp_ratio: float = 1.0, kernel_size: int = 3, stride: Optional[int] = None,
                 padding: Optional[int] = None, n_conv_layers: int = 2, max_pool: bool = True,
                 use_act: bool = True, seq_pool: bool = True, dropout: float = 0.0,
                 attention_dropout: float = 0.1, stochastic_depth: float = 0.1,
                 positional_embedding: str = "learnable", conv_bias: bool = False):
        super().__init__()
        if positional_embedding not in ("learnable", "sine", "none"):
            raise ValueError(f"positional_embedding {positional_embedding!r}")
        stride = stride if stride is not None else max(1, kernel_size // 2 - 1)
        padding = padding if padding is not None else max(1, kernel_size // 2)
        self.tokenizer = Tokenizer(
            kernel_size, stride, padding, n_conv_layers=n_conv_layers,
            n_output_channels=embedding_dim, in_planes=64, in_channels=in_channels,
            max_pool=max_pool, use_act=use_act, conv_bias=conv_bias,
        )
        self.seq_len = self.tokenizer.sequence_length(img_size) + (not seq_pool)
        self.embedding_dim = embedding_dim
        self.seq_pool = seq_pool
        self.positional = positional_embedding
        self.dropout = dropout
        self.class_emb = None if seq_pool else nn.Parameter(torch.zeros(1, 1, embedding_dim))
        self.positional_emb = (
            nn.Parameter(torch.zeros(1, self.seq_len, embedding_dim))
            if positional_embedding == "learnable" else None
        )
        # drop-path rates run linearly over the layers
        dpr = [stochastic_depth * i / max(num_layers - 1, 1) for i in range(num_layers)]
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embedding_dim, num_heads, int(embedding_dim * mlp_ratio),
                                    dropout, attention_dropout, rate)
            for rate in dpr
        )
        self.norm = nn.LayerNorm(embedding_dim, eps=LN_EPS)
        self.attention_pool = nn.Linear(embedding_dim, 1) if seq_pool else None
        self.fc = nn.Linear(embedding_dim, num_classes)

    def noise_sites(self, batch: int) -> NoiseSites:
        n, c = self.seq_len, self.embedding_dim
        sites = {"emb": ((batch, n, c), 1.0 - self.dropout)} if self.dropout else {}
        for i, layer in enumerate(self.layers):
            sites.update({f"layers.{i}.{k}": v for k, v in layer.noise_sites(batch, n).items()})
        return sites

    def forward(self, x: torch.Tensor, noise: Masks = None) -> torch.Tensor:
        x = self.tokenizer(x)
        if self.class_emb is not None:
            x = torch.cat([self.class_emb.expand(x.shape[0], -1, -1), x], dim=1)
        if self.positional_emb is not None:
            x = x + self.positional_emb
        elif self.positional == "sine":
            x = x + sinusoidal_embedding(x.shape[1], x.shape[2], x.device).to(x.dtype)
        x = dropout(x, _mask(noise, "emb", self.dropout), self.dropout)
        for i, layer in enumerate(self.layers):
            x = layer(x, noise, f"layers.{i}.")
        x = self.norm(x)
        if self.seq_pool:
            # softmax(Wx)^T x over the sequence
            w = self.attention_pool(x).softmax(dim=1)  # [B, N, 1]
            x = torch.einsum("bnl,bnc->bc", w, x)
        else:
            x = x[:, 0]
        return self.fc(x)

    # -- the flax tree --------------------------------------------------------

    def jax_paths(self) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]]:
        """torch name -> (flax path, perm). flax numbers Dense layers in
        call order: with sequence pooling the pool is ``Dense_0`` and the
        head ``Dense_1``, otherwise the head is ``Dense_0``."""
        paths = {}
        for i, conv in enumerate(self.tokenizer.convs):
            tok = ("Tokenizer_0", f"Conv_{i}")
            paths[f"tokenizer.convs.{i}.weight"] = (tok + ("kernel",), CONV2D)
            if conv.bias is not None:
                paths[f"tokenizer.convs.{i}.bias"] = (tok + ("bias",), ())
        if self.class_emb is not None:
            paths["class_emb"] = (("class_emb",), ())
        if self.positional_emb is not None:
            paths["positional_emb"] = (("positional_emb",), ())
        for i in range(len(self.layers)):
            layer, lp = f"layers.{i}", (f"TransformerEncoderLayer_{i}",)
            paths.update(_norm_paths(f"{layer}.pre_norm", lp + ("LayerNorm_0",)))
            paths.update(_dense_paths(f"{layer}.self_attn.qkv", lp + ("Attention_0", "Dense_0"),
                                      bias=False))
            paths.update(_dense_paths(f"{layer}.self_attn.proj", lp + ("Attention_0", "Dense_1")))
            paths.update(_norm_paths(f"{layer}.norm1", lp + ("LayerNorm_1",)))
            paths.update(_dense_paths(f"{layer}.linear1", lp + ("Dense_0",)))
            paths.update(_dense_paths(f"{layer}.linear2", lp + ("Dense_1",)))
        paths.update(_norm_paths("norm", ("LayerNorm_0",)))
        head = 0
        if self.attention_pool is not None:
            paths.update(_dense_paths("attention_pool", ("Dense_0",)))
            head = 1
        paths.update(_dense_paths("fc", (f"Dense_{head}",)))
        return paths

    def init_params(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """flax's inits: conv kernels ``kaiming_normal`` (fan_in =
        kh*kw*in), Dense kernels ``truncated_normal(0.02)``, the positional
        embedding ``truncated_normal(0.2)``, LayerNorm scales 1, biases and
        the class token 0."""
        params = {n: torch.zeros(p.shape) for n, p in self.named_parameters()}
        for name, m in self.named_modules():
            w = params.get(f"{name}.weight")
            if isinstance(m, nn.Conv2d):
                kaiming_normal_(w, math.prod(w.shape[1:]), generator)
            elif isinstance(m, nn.Linear):
                trunc_normal_(w, 0.02, generator)
            elif isinstance(m, nn.LayerNorm):
                w.fill_(1.0)
        if self.positional_emb is not None:
            trunc_normal_(params["positional_emb"], 0.2, generator)
        return params


# -- variant factories (reference cctnets/cct.py:121-254, cvt.py, vit.py) -----


def cct_2_3x2_32(num_classes: int = 10, img_size: int = 32, **kw) -> CCT:
    return CCT(num_classes=num_classes, img_size=img_size, num_layers=2, num_heads=2,
               mlp_ratio=1.0, embedding_dim=128, kernel_size=3, n_conv_layers=2, **kw)


def cct_4_3x2_32(num_classes: int = 10, img_size: int = 32, **kw) -> CCT:
    return CCT(num_classes=num_classes, img_size=img_size, num_layers=4, num_heads=2,
               mlp_ratio=1.0, embedding_dim=128, kernel_size=3, n_conv_layers=2, **kw)


def cct_6_3x1_32(num_classes: int = 10, img_size: int = 32, **kw) -> CCT:
    return CCT(num_classes=num_classes, img_size=img_size, num_layers=6, num_heads=4,
               mlp_ratio=2.0, embedding_dim=256, kernel_size=3, n_conv_layers=1, **kw)


def cct_7_3x1_32(num_classes: int = 10, img_size: int = 32, **kw) -> CCT:
    return CCT(num_classes=num_classes, img_size=img_size, num_layers=7, num_heads=4,
               mlp_ratio=2.0, embedding_dim=256, kernel_size=3, n_conv_layers=1, **kw)


def cvt_7_4_32(num_classes: int = 10, img_size: int = 32, **kw) -> CCT:
    """CVT: patchify tokenizer (4x4 conv, no act/pool) + seq-pool."""
    return CCT(num_classes=num_classes, img_size=img_size, num_layers=7, num_heads=4,
               mlp_ratio=2.0, embedding_dim=256, kernel_size=4, stride=4, padding=0,
               n_conv_layers=1, max_pool=False, use_act=False, conv_bias=True,
               seq_pool=True, **kw)


def vit_lite_7_4_32(num_classes: int = 10, img_size: int = 32, **kw) -> CCT:
    """ViT-Lite: patchify tokenizer + class token instead of seq-pool."""
    return CCT(num_classes=num_classes, img_size=img_size, num_layers=7, num_heads=4,
               mlp_ratio=2.0, embedding_dim=256, kernel_size=4, stride=4, padding=0,
               n_conv_layers=1, max_pool=False, use_act=False, conv_bias=True,
               seq_pool=False, **kw)


# reference wrapper-class name (src/blades/models/cifar10/cct.py:6-16)
CCTNet = cct_2_3x2_32
