"""Buffered-asynchronous (FedBuff) rounds (counterpart:
``blades_tpu/asyncfl/__init__.py``): a seeded arrival process
(``arrivals.py``), the server buffer with staleness weighting
(``buffer.py``), and the round body (``engine.py``) that
:class:`blades_tpu_torch.core.RoundEngine` runs when built with
``async_config=`` (``Simulator.run(async_config=...)``). With ``buffer_m=K``,
zero delays and constant weighting a round is bit-identical to the
synchronous one."""

from blades_tpu_torch.asyncfl.arrivals import ArrivalProcess, geometric_delays
from blades_tpu_torch.asyncfl.buffer import STALENESS_MODES, AsyncConfig

__all__ = ["ArrivalProcess", "AsyncConfig", "STALENESS_MODES", "geometric_delays"]
