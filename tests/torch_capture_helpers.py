"""Argument capture for the drivers' tests (``tests/test_torch_drivers.py``,
``tests/test_torch_examples.py``). Not a test module.

A recorder stands in for ``Simulator`` in both packages where a driver
looks it up. It records the constructor's arguments, each ``run``'s, and
the other calls an example makes (``evaluate``, ``register_attackers``,
``set_trusted_clients``), and gives back what the examples read after a
run, so that each runs to its end:

- ``run`` writes one ``test`` record to ``<log_path>/stats`` and a
  ``telemetry.jsonl`` with one ``round`` record whose gauges are the
  streaming demo's (peak update bytes 1 streaming, 2 dense), and calls an
  ``on_round_end`` hook once a round (so a hook that raises, as the fault
  demo's kill does, raises out of ``run``);
- ``evaluate`` gives a loss of 1.0 and a top-1 of 0.5;
- the final params are zeros in each package's own form
  (:class:`JaxRecorder`, :class:`PortRecorder`).

``captured`` maps what was recorded to plain values for comparison:
models to their class names, datasets to (class, clients, iid, alpha,
seed, batch size, train size, test size, noise), dataclasses (optimizer
specs, fault models) to their fields, functions to their names.
"""

import dataclasses
import json
import os
import types
from pathlib import Path

import flax.linen as flax_nn
import numpy as np
import torch

PEAK_DENSE, PEAK_STREAMING = 2, 1


class Recorder:
    """Stands in for ``Simulator`` (see the module docstring)."""

    calls = []

    def __init__(self, *args, **kwargs):
        self.init = (args, kwargs)
        self.runs = []
        self.others = []
        self.engine = types.SimpleNamespace(peak_update_bytes=0, layout=None)
        self.server = types.SimpleNamespace(state=types.SimpleNamespace(params=self._params()))
        Recorder.calls.append(self)

    def _params(self):
        return {"w": np.zeros(2, np.float32)}

    def run(self, *args, **kwargs):
        self.runs.append((args, kwargs))
        streaming = bool(kwargs.get("streaming"))
        self.engine.peak_update_bytes = PEAK_STREAMING if streaming else PEAK_DENSE
        log = self.init[1].get("log_path")
        if log:
            os.makedirs(log, exist_ok=True)
            with open(os.path.join(log, "stats"), "w") as fh:
                fh.write(repr({"_meta": {"type": "test"}, "Round": 1, "Loss": 1.0,
                               "top1": 0.5}) + "\n")
            gauges = {"engine.peak_update_bytes": self.engine.peak_update_bytes,
                      "engine.client_chunks": kwargs.get("client_chunks", 1),
                      "engine.chunk_size": 1, "engine.streaming": int(streaming)}
            with open(os.path.join(log, "telemetry.jsonl"), "w") as fh:
                fh.write(json.dumps({"t": "round", "gauges": gauges}) + "\n")
        hook = kwargs.get("on_round_end")
        for rnd in range(1, int(kwargs.get("global_rounds", 0)) + 1):
            if hook is not None:
                hook(rnd, None, {})
        return []

    def evaluate(self, *args, **kwargs):
        self.others.append(("evaluate", args, kwargs))
        return {"Loss": 1.0, "top1": 0.5}

    def register_attackers(self, clients):
        self.attackers = [c.make_attack() for c in clients]
        self.others.append(("register_attackers", [type(c).__name__ for c in clients],
                            [type(a).__name__ for a in self.attackers]))

    def get_clients(self):
        n = self.init[0][0].num_clients if self.init[0] else self.init[1]["dataset"].num_clients
        return [types.SimpleNamespace(id=lambda i=i: i) for i in range(n)]

    def set_trusted_clients(self, ids):
        self.others.append(("set_trusted_clients", list(ids)))


class JaxRecorder(Recorder):
    """The recorder in the JAX package: its params a dict of numpy arrays
    (``blades_tpu.ops.pytree.ravel`` flattens them)."""


class PortRecorder(Recorder):
    """The recorder in the port: its params a dict of tensors with their
    ``FlatLayout`` (``blades_tpu_torch.ops.pytree.ravel``)."""

    def __init__(self, *args, **kwargs):
        from blades_tpu_torch.ops.pytree import FlatLayout, LeafSpec

        super().__init__(*args, **kwargs)
        self.engine.layout = FlatLayout((LeafSpec("w", ("w",), (2,)),))

    def _params(self):
        return {"w": torch.zeros(2)}


def mapped(value):
    """What was recorded, as plain values (see the module docstring)."""
    if isinstance(value, dict):
        return {k: mapped(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(mapped(v) for v in value)
    if isinstance(value, (torch.nn.Module, flax_nn.Module)):
        return type(value).__name__
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__, mapped(dataclasses.asdict(value)))
    if hasattr(value, "num_clients") and hasattr(value, "train_bs"):
        return (type(value).__name__, value.num_clients, value.iid, value.alpha, value.seed,
                value.train_bs, *(getattr(value, n, None)
                                  for n in ("train_size", "test_size", "noise")))
    if isinstance(value, (str, int, float, bool, type(None))):
        return value
    if isinstance(value, types.FunctionType):
        return ("function", value.__name__)
    return type(value).__name__


def captured(calls, drop=("device",)):
    """Each recorder's constructor arguments (``drop`` left out, the log
    path by its last component), its runs and its other calls."""
    out = []
    for rec in calls:
        args, kwargs = rec.init
        kwargs = {k: v for k, v in kwargs.items() if k not in drop}
        if "log_path" in kwargs:  # the encoding, not the root
            kwargs["log_path"] = Path(kwargs["log_path"]).name
        out.append((mapped(args), mapped(kwargs), mapped(rec.runs), mapped(rec.others)))
    return out


def devices(calls):
    return [rec.init[1].get("device") for rec in calls]


def patch_simulators(monkeypatch):
    """The recorders in place of both packages' ``Simulator`` where a
    driver imports it from the package (``from blades_tpu import
    Simulator``, ``blades_tpu.simulator``, ``from blades_tpu_torch import
    Simulator``); a module that bound it at import is patched by its test."""
    import blades_tpu
    import blades_tpu.simulator as jsim
    import blades_tpu_torch

    Recorder.calls = []
    monkeypatch.setattr(blades_tpu, "Simulator", JaxRecorder, raising=False)
    monkeypatch.setattr(jsim, "Simulator", JaxRecorder)
    monkeypatch.setattr(blades_tpu_torch, "Simulator", PortRecorder, raising=False)
