"""Server handle.

Counterpart: ``blades_tpu/server.py:15-48``. The server step runs inside the
round (``core/engine.py``); this object is the host-side view with the
reference's accessors.
"""

from __future__ import annotations

from typing import Any


class BladesServer:
    def __init__(self, engine, state, aggregator):
        self._engine = engine
        self.state = state
        self.aggregator = aggregator

    def get_model(self) -> Any:
        """Current global params dict."""
        return self.state.params

    def get_opt(self) -> Any:
        """Server optimizer state."""
        return self.state.server_opt_state

    def zero_grad(self, set_to_none: bool = False) -> None:
        """No-op: a functional step keeps no grads; kept for API parity."""

    def apply_update(self, update, server_lr: float = 0.1) -> None:
        """Apply an aggregated ``[D]`` vector as a pseudo-gradient step
        outside the round."""
        server_updates, opt_state = self._engine._server_tx.update(
            self._engine.unravel(-update), self.state.server_opt_state, self.state.params
        )
        params = {
            n: p - server_lr * server_updates[n] for n, p in self.state.params.items()
        }
        self.state = self.state._replace(params=params, server_opt_state=opt_state)
