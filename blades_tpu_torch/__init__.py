"""blades_tpu_torch: the PyTorch/CUDA port of ``blades_tpu``.

A second package beside the JAX one, written for one NVIDIA H100. It keeps
``blades_tpu``'s module names so each counterpart is easy to find, and its
entry points run on the card unless the caller asks for the CPU
(``Simulator(..., device="cpu")``). It imports nothing of ``blades_tpu`` and
nothing of JAX: what it shares with the JAX package it keeps as its own copy.

Ported so far: the synchronous dense fedsgd round with the MLP and the CCT
family (CCT-2 is the headline model; dropout and DropPath masks drawn per
round, and a bf16 ``compute_dtype``), every attack of the JAX registry, and
the defenses of the reference's catalog and BASELINE.md (mean, trimmed
mean, median, Krum, Multi-Krum, GeoMed, AutoGM, centered clipping,
clustering, clipped clustering, FLTrust, DnC) with ByzantineSGD, SignGuard,
the async pair and the gossip aggregators, and partial participation: the fault model
(``faults/``) and every registered defense's masked form; the streaming
round (``Simulator.run(streaming=True)``), which feeds the update matrix
to the defense one ``[chunk, D]`` slab at a time; mixed attacker
populations (``Simulator.register_attackers``) and client optimizer state
kept across rounds (``ClientOptSpec(persist=True)``); and the
buffered-asynchronous round (``Simulator.run(async_config=...)``,
``asyncfl/``) with the async aggregators. Multi-round execution too:
``Simulator.run(block_size=...)`` and ``RoundEngine.run_block``, which on
the card replay one captured CUDA graph of the round (``core/graphs.py``),
``ExperimentBatch`` (``core/experiments.py``), ``EngineCache``
(``sweeps/``, ``run(engine_cache=...)``); every round of the Simulator
donates its batch to the engine (``run(donate_batches=...)`` is accepted
and changes nothing). Real data: the MNIST, CIFAR-10, CIFAR-100 and custom
loaders (``datasets/``, local files only), uint8 on the device, augmented
and normalized in the round's sampler (``datasets/augment.py``); and
resumable runs: checkpoints, the crash autosave and bit-exact resume
(``utils/checkpoint.py``, ``Simulator.run(checkpoint_path=...,
resume=...)``). In-round forensics and the telemetry trace:
``Simulator.run(collect_diagnostics=..., round_metrics=...,
audit_monitor=AuditMonitor(...), profile_dir=...)`` records what the
defense decided, the audit's certificates (``audit/``) and the metric pack
(``telemetry/metric_pack.py``) of every round in
``<log_path>/telemetry.jsonl`` (``telemetry/``). The
coordinate-wise trimmed mean runs on the card through a CUDA kernel
written by hand for Hopper (``csrc/trimmed_mean.cu``, bound in
``ops/trimmed.py``); the other defenses and the masked trimmed mean are
stock torch ops, as the JAX package leaves them to XLA. What is still to
port, and in which order, is queue A of ``ROADMAP.md``.

Top-level names resolve lazily (PEP 562), as in ``blades_tpu/__init__.py:54``,
so importing a subpackage stays light.
"""

from __future__ import annotations

_LAZY = {
    "Simulator": "blades_tpu_torch.simulator",
    "RoundEngine": "blades_tpu_torch.core.engine",
    "ClientOptSpec": "blades_tpu_torch.core.engine",
    "ServerOptSpec": "blades_tpu_torch.core.engine",
    "ExperimentBatch": "blades_tpu_torch.core.experiments",
    "AuditMonitor": "blades_tpu_torch.audit",
    "EngineCache": "blades_tpu_torch.sweeps",
    "get_aggregator": "blades_tpu_torch.aggregators",
    "get_attack": "blades_tpu_torch.attackers",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'blades_tpu_torch' has no attribute {name!r}")
