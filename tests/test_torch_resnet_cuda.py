"""The BASELINE models' vmapped client step on the card against the CPU
(``models/resnet.py``, ``models/wrn.py``): narrow ResNet-18 and
WideResNet-16-2 twins, per-client params and batches under
``torch.func.vmap(grad_and_value)`` as the round engine runs them (cuDNN's
grouped convolutions, GroupNorm with per-client scales). float64 on both
within a relative L2 of 1e-6 per client: in float32 a ReLU input within
rounding of 0 takes either side on either backend, so the two are held in
float64, as ``chip_smoke.py``'s ``resnet_card_vs_cpu`` does at full width,
and the loss's log-softmax is taken in float32 (``models/common.py:
cross_entropy``), which leaves the two about 1e-7 apart (3.4e-8 and 8.1e-8
on an H100); bf16 on the card finite. torch's batching-rule fallback warning is an
error. Every case needs the card and carries the ``cuda`` marker; the file
imports nothing of JAX or flax, so on the card it runs as ``python -m
pytest --noconftest tests/test_torch_resnet_cuda.py``.
"""

import pytest
import torch

from blades_tpu_torch.models import build_fns, resnet, wrn
from blades_tpu_torch.ops.pytree import ravel
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

CIFAR = (32, 32, 3)
TWINS = {
    "resnet18-w8": lambda: resnet.ResNet((2, 2, 2, 2), width=8),
    "wrn16-2": lambda: wrn.WideResNet(depth=16, widen_factor=2),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's convolutions and GroupNorm")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.filterwarnings(
    "error:.*performance drop because we have not yet implemented the batching rule")
@pytest.mark.parametrize("name", sorted(TWINS))
def test_card_vmapped_client_grads_match_cpu(card, name):
    spec = build_fns(TWINS[name]())
    base = spec.init(torch.Generator().manual_seed(1))
    n, g = 3, torch.Generator().manual_seed(2)
    p = {k: (v + 0.01 * torch.randn((n, *v.shape), generator=g)).double()
         for k, v in base.items()}
    x = torch.randn(n, 4, *CIFAR, generator=g, dtype=torch.float64)
    y = torch.randint(0, 10, (n, 4), generator=g)
    fn = torch.func.grad_and_value(lambda q, a, b: spec.train_loss_fn(q, a, b), has_aux=True)
    rows = []
    for dev in (card, "cpu"):
        grads, _ = torch.func.vmap(fn)({k: v.to(dev) for k, v in p.items()}, x.to(dev),
                                      y.to(dev))
        rows.append(torch.func.vmap(lambda q: ravel(q, spec.layout))(grads).cpu())
    on_card, on_cpu = rows
    assert ((on_card - on_cpu).norm(dim=1) / on_cpu.norm(dim=1)).max() <= 1e-6
    bf16 = build_fns(spec.module, compute_dtype=torch.bfloat16)
    fn = torch.func.grad_and_value(lambda q, a, b: bf16.train_loss_fn(q, a, b), has_aux=True)
    grads, (loss, _) = torch.func.vmap(fn)(
        {k: v.float().to(card) for k, v in p.items()}, x.float().to(card), y.to(card))
    assert all(bool(torch.isfinite(t).all()) for t in grads.values())
    assert bool(torch.isfinite(loss).all())
