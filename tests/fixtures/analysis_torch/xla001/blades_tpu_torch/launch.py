"""Fixture: XLA001. Reference counterpart: none — lint fixture."""
import torch


def fast_convs():
    torch.backends.cudnn.benchmark = True  # VIOLATION: a switch outside platform.py
