"""Fixture: PAL001. Reference counterpart: none — lint fixture."""
import functools

import torch

from blades_tpu_torch.ops import _build

column_sum_launches = 0


@functools.lru_cache(maxsize=None)
def _library():
    return _build.load("column_sum")


def column_sum_plain(x):
    return x.sum(dim=0)


def column_sum_cuda(x):
    global column_sum_launches
    out = torch.empty(x.shape[1], device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _library().column_sum(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], stream)
    column_sum_launches += 1
    return out


def column_sum(x):
    if x.device.type == "cpu":
        return column_sum_plain(x)
    try:
        return column_sum_cuda(x)
    except RuntimeError:  # VIOLATION: a fallback that hides the kernel
        return column_sum_plain(x)
