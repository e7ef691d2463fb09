"""Metric callables (counterpart: ``blades_tpu/utils/metrics.py:14-27``):
``{name: fn(output, target)}``, top-k accuracy in percent."""

from __future__ import annotations

import torch


def accuracy(output: torch.Tensor, target: torch.Tensor, topk=(1,)):
    """Precision@k for each k, in percent (reference scale)."""
    maxk = max(topk)
    top_idx = torch.topk(output, maxk, dim=-1).indices  # [B, maxk]
    correct = top_idx == target[:, None]
    return [100.0 * correct[:, :k].any(dim=-1).to(torch.float32).mean() for k in topk]


def top1_accuracy(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return accuracy(output, target, topk=(1,))[0]
