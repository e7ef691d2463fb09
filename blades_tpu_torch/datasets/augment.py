"""Image augmentations and the normalizer, batched over ``[N, H, W, C]``.

Counterpart: ``blades_tpu/datasets/augment.py``, where each function takes
one ``[H, W, C]`` image and a key and the sampler ``vmap``s it over a
round's images. Here every function takes the whole batch, in any dtype (the
store is uint8), and is split in two:

- the **draws** (:func:`draw_cifar_params`): per-image crop offsets, flip
  and erasing parameters from one ``torch.Generator``, with the JAX code's
  distributions and bounds;
- the **application** (:func:`apply_cifar_transform`), pure: reflect-pad,
  crop and flip as one index gather (no padded copy, no loop over images),
  then erasing as one ``torch.where`` on a box mask.

The split lets a test hand the JAX package's draws to the port, and a
sampler laid out by mesh rows (``datasets/fl.py:FLDataset.place``) draw a
round's parameters once and apply each row's slice of them on the row's
device (``cifar_train_transform.draw`` / ``.apply``). Neither
part synchronizes with the host, so the sampler that calls them can be
captured in a CUDA graph (``core/graphs.py``).

The normalizer (:func:`make_normalizer`) multiplies by the float32
reciprocal of ``std * 255``: under ``jax.jit``, which is how the JAX
sampler runs it, XLA rewrites the division by that constant as this
product, so ``Normalizer.__call__`` equals the jitted sampler's output bit
for bit. An eager JAX call divides; :meth:`Normalizer.divide` is that form,
for the test set (``FLDataset.test_x``) and ``get_train_data``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

#: torchvision's RandomErasing defaults, as the JAX code keeps them
ERASE_AREA = (0.02, 0.2)
ERASE_RATIO = (0.3, 3.3)


class CifarParams(NamedTuple):
    """Per-image draws of :func:`cifar_train_transform`, each ``[N]``."""

    top: torch.Tensor  # int64 crop row offset in the padded image, [0, 2 * pad]
    left: torch.Tensor  # int64 crop column offset, [0, 2 * pad]
    flip: torch.Tensor  # bool
    frac: torch.Tensor  # float32 erased area fraction, in ERASE_AREA
    log_r: torch.Tensor  # float32 log aspect ratio, in log(ERASE_RATIO)
    etop: torch.Tensor  # int64 erasing box row, [0, H)
    eleft: torch.Tensor  # int64 erasing box column, [0, W)
    erase: torch.Tensor  # bool


def _uniform(generator, n, lo, hi):
    u = torch.rand(n, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def _bernoulli(generator, n, p):
    return torch.rand(n, generator=generator, device=generator.device) < p


def _randint(generator, n, hi):
    return torch.randint(0, hi, (n,), generator=generator, device=generator.device)


def draw_cifar_params(generator: torch.Generator, n: int, h: int, w: int, padding: int = 4,
                      flip_p: float = 0.5, erase_p: float = 0.25) -> CifarParams:
    """The draws of ``n`` images' crop, flip and erasing, in that order,
    from ``generator`` (on its device): the bounds of ``random_crop``
    (``randint(0, 2 * padding + 1)``), ``random_hflip`` (``bernoulli(0.5)``)
    and ``random_erasing`` (``uniform`` area and log ratio, ``randint`` box
    corner, ``bernoulli(0.25)``) of the JAX code."""
    g = generator
    return CifarParams(
        top=_randint(g, n, 2 * padding + 1),
        left=_randint(g, n, 2 * padding + 1),
        flip=_bernoulli(g, n, flip_p),
        frac=_uniform(g, n, *ERASE_AREA),
        log_r=_uniform(g, n, math.log(ERASE_RATIO[0]), math.log(ERASE_RATIO[1])),
        etop=_randint(g, n, h),
        eleft=_randint(g, n, w),
        erase=_bernoulli(g, n, erase_p),
    )


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``reflect`` padding (no edge repeat) as a source index, for
    offsets less than ``n`` outside ``[0, n)``."""
    i = torch.abs(i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def crop_flip(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor, flip: torch.Tensor,
              padding: int) -> torch.Tensor:
    """Reflect-pad each image by ``padding``, crop ``H x W`` at
    ``(top, left)`` of the padded image, then mirror the columns where
    ``flip``: ``out[i, y, c] = x[i, reflect(top_i + y - pad),
    reflect(left_i + (flip_i ? W - 1 - c : c) - pad)]``, one gather."""
    n, h, w = x.shape[:3]
    dev = x.device
    ys = torch.arange(h, device=dev)[None, :]
    xs = torch.arange(w, device=dev)[None, :]
    rows = _reflect(top[:, None] + ys - padding, h)
    cols = _reflect(left[:, None] + torch.where(flip[:, None], (w - 1) - xs, xs) - padding, w)
    return x[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]


def erase_boxes(x: torch.Tensor, frac: torch.Tensor, log_r: torch.Tensor, etop: torch.Tensor,
                eleft: torch.Tensor, erase: torch.Tensor) -> torch.Tensor:
    """Zero each image's box where ``erase``: height ``int32(sqrt(frac * H
    * W * r))`` and width ``int32(sqrt(frac * H * W / r))``, ``r =
    exp(log_r)``, each clipped to ``[1, H]`` / ``[1, W]``, in float32 as
    the JAX code computes them, from corner ``(etop, eleft)`` (clipped at
    the image's edge)."""
    n, h, w = x.shape[:3]
    dev = x.device
    r = torch.exp(log_r)
    eh = torch.sqrt(frac * h * w * r).to(torch.int32).clamp(1, h)
    ew = torch.sqrt(frac * h * w / r).to(torch.int32).clamp(1, w)
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    box = lambda t: t[:, None, None]  # noqa: E731
    inside = ((rows >= box(etop)) & (rows < box(etop + eh))
              & (cols >= box(eleft)) & (cols < box(eleft + ew)))
    mask = inside & box(erase)
    return torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 3)),
                       torch.zeros((), dtype=x.dtype, device=dev), x)


def apply_cifar_transform(x: torch.Tensor, params: CifarParams, padding: int = 4) -> torch.Tensor:
    """Crop, flip, then erasing of ``x`` ``[N, H, W, C]`` on ``params``
    (pure: the same draws give the same images)."""
    x = crop_flip(x, params.top, params.left, params.flip, padding)
    return erase_boxes(x, params.frac, params.log_r, params.etop, params.eleft, params.erase)


def random_crop(x: torch.Tensor, generator: torch.Generator, padding: int = 4) -> torch.Tensor:
    """Reflect-pad by ``padding``, then a random ``H x W`` crop per image."""
    n = x.shape[0]
    top = _randint(generator, n, 2 * padding + 1)
    left = _randint(generator, n, 2 * padding + 1)
    return crop_flip(x, top, left, torch.zeros_like(top, dtype=torch.bool), padding)


def random_hflip(x: torch.Tensor, generator: torch.Generator, p: float = 0.5) -> torch.Tensor:
    """Mirror each image's columns with probability ``p``."""
    n = x.shape[0]
    zero = torch.zeros(n, dtype=torch.int64, device=x.device)
    return crop_flip(x, zero, zero, _bernoulli(generator, n, p), 0)


def random_erasing(x: torch.Tensor, generator: torch.Generator, p: float = 0.25,
                   area: Tuple[float, float] = ERASE_AREA) -> torch.Tensor:
    """Zero a random box of each image with probability ``p``
    (torchvision RandomErasing's area and aspect-ratio ranges)."""
    n, h, w = x.shape[:3]
    frac = _uniform(generator, n, *area)
    log_r = _uniform(generator, n, math.log(ERASE_RATIO[0]), math.log(ERASE_RATIO[1]))
    etop, eleft = _randint(generator, n, h), _randint(generator, n, w)
    return erase_boxes(x, frac, log_r, etop, eleft, _bernoulli(generator, n, p))


def cifar_train_transform(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Crop, flip and erasing of a batch ``[N, 32, 32, 3]`` (any dtype):
    the batched form ``(x, generator) -> x`` the sampler calls.

    Its split form is two attributes, ``draw`` (:func:`draw_cifar_params`,
    ``(generator, n, h, w) -> CifarParams``) and ``apply``
    (:func:`apply_cifar_transform`, ``(x, params) -> x``), with
    ``cifar_train_transform(x, g) == apply(x, draw(g, n, h, w))``. A
    sampler laid out by mesh rows (``FLDataset.place``) draws every image's
    parameters at once, as this call does, and applies each row's slice of
    them on the row's device."""
    n, h, w = x.shape[:3]
    return apply_cifar_transform(x, draw_cifar_params(generator, n, h, w))


cifar_train_transform.draw = draw_cifar_params
cifar_train_transform.apply = apply_cifar_transform


class Normalizer:
    """``(x - mean * 255) / (std * 255)`` in float32, channels last.

    ``__call__`` multiplies by the float32 reciprocal of ``std * 255`` (the
    jitted JAX sampler's arithmetic); :meth:`divide` divides (an eager JAX
    call's). The constants are copied to a device once, on the first call
    there, so a captured round (its eager warm-up runs first) copies
    nothing from the host."""

    def __init__(self, mean: Tuple[float, ...], std: Tuple[float, ...]):
        self.mean = torch.tensor(mean, dtype=torch.float32) * 255.0
        self.std = torch.tensor(std, dtype=torch.float32) * 255.0
        self.inv_std = 1.0 / self.std
        self._on = {}

    def _consts(self, device: torch.device):
        consts = self._on.get(device)
        if consts is None:
            consts = self._on[device] = tuple(
                t.to(device) for t in (self.mean, self.std, self.inv_std))
        return consts

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mean, _, inv_std = self._consts(x.device)
        return (x.to(torch.float32) - mean) * inv_std

    def divide(self, x: torch.Tensor) -> torch.Tensor:
        mean, std, _ = self._consts(x.device)
        return (x.to(torch.float32) - mean) / std


def make_normalizer(mean: Tuple[float, ...], std: Tuple[float, ...]) -> Normalizer:
    """uint8 ``[0, 255]`` -> float32 standardized, on the data's device."""
    return Normalizer(mean, std)


def eager_normalize(normalize, x: torch.Tensor) -> torch.Tensor:
    """``normalize`` as an eager JAX call applies it: a :class:`Normalizer`
    divides; any other callable is called."""
    return getattr(normalize, "divide", normalize)(x)
