"""Fixture: ALIAS001. Reference counterpart: none — lint fixture."""
import numpy as np
import torch


def restore(path, n):
    z = np.load(path)
    return [torch.from_numpy(z[f"leaf_{i}"]) for i in range(n)]  # VIOLATION
