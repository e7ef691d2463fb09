"""Long-context text classification: ring against Ulysses sequence
parallelism (counterpart: ``examples/long_context.py``).

The reference caps attention at 256 tokens on one device
(``cctnets/utils/transformers.py:8-37``). Here the token axis of
``long_text_transformer`` is split over a ``seq`` mesh and every encoder
layer runs exact sequence-parallel attention, by either schedule, and both
are held to the dense model's logits at the JAX example's bar (3e-4):

- ``seq_parallel="ring"`` (``ops/ring_attention.py``): K/V blocks rotate
  from device to device; the activation memory of one step is O(N/P);
- ``seq_parallel="ulysses"`` (``ops/ulysses.py``): two reshards bracket a
  head-parallel local attention; needs the heads divisible by the axis.

Knobs (environment, as in the JAX example): ``LC_SEQ`` (sequence length,
default 512), ``LC_BATCH`` (default 2), ``LC_DEVICES`` (default 8): the
number of entries of the ``seq`` mesh, each the run's one device
(``--device``; the card by default), a virtual mesh.

    python -m blades_tpu_torch.examples.long_context [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from blades_tpu_torch.utils.platform import apply_numerics

#: the JAX example's model and bar
MODEL_KW = dict(num_classes=4, num_heads=8, word_embedding_dim=128)
BAR = 3e-4


def build(seq: int, n_dev: int, device):
    """``(mesh, {"dense", "ring", "ulysses"} -> model)`` on ``device``: one
    init (a generator of seed 1), shared by the three models."""
    from blades_tpu_torch.models import long_text_transformer
    from blades_tpu_torch.parallel import Mesh

    mesh = Mesh([device] * n_dev, ("seq",))
    models = {"dense": long_text_transformer(mesh=None, seq_len=seq, **MODEL_KW)}
    params = models["dense"].init_params(torch.Generator().manual_seed(1))
    models["dense"].load_state_dict(params)
    for name in ("ring", "ulysses"):
        models[name] = long_text_transformer(mesh=mesh, seq_parallel=name, seq_len=seq,
                                             **MODEL_KW)
        models[name].load_state_dict(params)
    return mesh, {n: m.to(device).eval() for n, m in models.items()}


def inputs(seq: int, batch: int, device, seed: int = 0):
    """Tokens in ``[0, 1000)`` and a validity mask whose lengths are drawn
    in ``[seq / 2, seq]``, as the JAX example draws them."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, 1000, (batch, seq), generator=g)
    lens = torch.randint(seq // 2, seq + 1, (batch, 1), generator=g)
    mask = torch.arange(seq)[None, :] < lens
    return tokens.to(device), mask.to(device)


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    ap = argparse.ArgumentParser(description="ring and Ulysses attention against the dense model")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = ap.parse_args(argv)

    from blades_tpu_torch.core.engine import resolve_device

    device = resolve_device(args.device)
    seq = int(os.environ.get("LC_SEQ", 512))
    batch = int(os.environ.get("LC_BATCH", 2))
    n_dev = int(os.environ.get("LC_DEVICES", 8))
    _, models = build(seq, n_dev, device)
    tokens, mask = inputs(seq, batch, device)
    n_params = sum(p.numel() for p in models["dense"].parameters())
    print(f"seq_len={seq} batch={batch} devices={n_dev} x {device} params={n_params}")
    with torch.no_grad():
        ref = models["dense"](tokens, None, mask)
        errs = {}
        for name in ("ring", "ulysses"):
            out = models[name](tokens, None, mask)
            errs[name] = float((out - ref).abs().max())
            ok = errs[name] < BAR
            print(f"{name:8s} max|logit - dense| = {errs[name]:.2e}  "
                  f"{'OK' if ok else 'MISMATCH'}")
            if not ok:
                raise SystemExit(f"{name} diverged from the dense oracle")
    print("both sequence-parallel schedules match the dense model")
    return {"seq": seq, "batch": batch, "devices": n_dev, "params": n_params, "errs": errs}


if __name__ == "__main__":
    main()
