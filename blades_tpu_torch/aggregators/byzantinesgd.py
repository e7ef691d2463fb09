"""ByzantineSGD filter (Alistarh et al., NeurIPS 2018).

Counterpart: ``blades_tpu/aggregators/byzantinesgd.py`` (``_vector_median_idx``
:23, ``Byzantinesgd._aggregate_impl`` :66). Each client accumulates a scalar
``A_i += <u_i, theta - theta_0>`` and a vector ``B_i += u_i`` across rounds;
three median-distance filters (``th_A`` on A, ``th_B`` on B, ``th_V`` on the
round's updates) remove clients from the good set for good, and the
aggregate is the mean of the good clients' updates.

The state is the JAX package's: ``A [K]``, ``B [K, D]`` float32 (1.13 GB at
CCT-2's K=1000), the ``good`` mask, the parameters of the first call
``init_params [D]`` and the ``initialized`` flag, made on the CPU by
:meth:`Byzantinesgd.init_state` and moved to the updates' device by the
first aggregate. The current flat parameters arrive as ``params_flat`` in
the aggregator context. In the masked form an absent client's A and B stay
as they were, the filters run on them, and the mean weights the good
participants only.
"""

from __future__ import annotations

import torch

from blades_tpu_torch.aggregators.base import Aggregator
from blades_tpu_torch.aggregators.median import midpoint_median
from blades_tpu_torch.ops.distances import pairwise_sq_euclidean


def _vector_median_idx(vs: torch.Tensor, threshold: float) -> torch.Tensor:
    """Index (0-d) of the first row within ``threshold`` of more than half
    the rows, itself included; 0 when no row is."""
    d = torch.sqrt(pairwise_sq_euclidean(vs))
    ok = (d <= threshold).sum(dim=1) > vs.shape[0] / 2
    return torch.argmax(ok.to(torch.int32))  # the first maximum


class Byzantinesgd(Aggregator):
    stateful = True

    streaming_optouts = {
        "streaming": "per-client B accumulators are themselves [K, D] "
                     "state and the median-distance filters compare every "
                     "client against every other; the defense is "
                     "inherently dense in K",
    }

    def __init__(self, th_A: float = 1.0, th_B: float = 1.0, th_V: float = 1.0):
        self.th_A = th_A
        self.th_B = th_B
        self.th_V = th_V

    def init_state(self, num_clients: int, dim: int):
        # made on the CPU; the first aggregate moves it to the updates' device
        return {
            "A": torch.zeros(num_clients, dtype=torch.float32),
            "B": torch.zeros(num_clients, dim, dtype=torch.float32),
            "good": torch.ones(num_clients, dtype=torch.bool),
            "init_params": torch.zeros(dim, dtype=torch.float32),
            "initialized": torch.zeros((), dtype=torch.bool),
        }

    def aggregate(self, updates, state, *, params_flat=None, **ctx):
        return self._aggregate_impl(updates, state, params_flat, None)

    def _masked_aggregate(self, updates, state, *, mask, params_flat=None, **ctx):
        return self._aggregate_impl(updates, state, params_flat, mask)

    def _aggregate_impl(self, updates, state, params_flat, mask):
        if params_flat is None:
            raise ValueError("byzantinesgd needs params_flat context")
        dev = updates.device
        st = {n: t.to(dev) for n, t in state.items()}
        params_flat = params_flat.to(dev, updates.dtype)
        init_params = torch.where(st["initialized"], st["init_params"], params_flat)
        inc_a = updates @ (params_flat - init_params)
        inc_b = updates
        if mask is not None:
            inc_a = torch.where(mask, inc_a, 0.0)
            inc_b = torch.where(mask[:, None], inc_b, 0.0)
        A = st["A"] + inc_a
        B = st["B"] + inc_b

        b_med = B.index_select(0, _vector_median_idx(B, self.th_B).view(1))
        g_med = updates.index_select(0, _vector_median_idx(updates, 2 * self.th_V).view(1))
        a_ok = torch.abs(A - midpoint_median(A)) <= self.th_A
        b_ok = torch.linalg.vector_norm(B - b_med, dim=1) <= self.th_B
        g_ok = torch.linalg.vector_norm(updates - g_med, dim=1) <= 4 * self.th_V
        good = st["good"] & a_ok & b_ok & g_ok

        w = good.to(updates.dtype)
        if mask is not None:
            w = w * mask.to(updates.dtype)
        agg = (w @ updates) / torch.clamp_min(w.sum(), 1.0)
        new_state = {
            "A": A, "B": B, "good": good, "init_params": init_params,
            "initialized": torch.ones((), dtype=torch.bool, device=dev),
        }
        return agg, new_state
