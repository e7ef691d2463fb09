"""Fixture: SYNC001. Reference counterpart: none — lint fixture."""
import torch


def aggregate(updates, state=(), **ctx):
    norm = torch.linalg.vector_norm(updates, dim=1)
    worst = norm.max().item()  # VIOLATION: host sync in the round body
    return updates.mean(dim=0) / worst, state
