"""Streaming client axis: ``[chunk, D]`` peak update memory, independent of
K (counterpart: ``examples/streaming_clients.py``).

The dense round materializes the whole ``[K, D]`` post-attack update
matrix before aggregating, so device memory caps the client axis. With
``streaming=True`` the round trains chunk after chunk and feeds ``[chunk,
D]`` slabs into the aggregator's streaming state. This demo runs the same
small federation both ways and shows:

1. the telemetry's memory gauges (``engine.peak_update_bytes`` and the
   chunk layout, on each ``round`` record; on the card also the run's
   ``memory`` record) giving ``[K, D]`` for the dense run and ``[chunk,
   D]`` for the streaming one;
2. the two runs training alike (the streaming trimmed mean is the
   two-level form: a trim within each chunk, then across the chunks'
   aggregates; the dense run's is the card's kernel once a round);
3. a chunk count that does not divide K: the engine pads the last chunk.

    python -m blades_tpu_torch.examples.streaming_clients [--rounds 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from blades_tpu_torch.utils.platform import apply_numerics


def memory_gauges(log_path):
    with open(os.path.join(log_path, "telemetry.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("t") == "round":
                g = rec.get("gauges", {})
                if "engine.peak_update_bytes" in g:
                    return {
                        k.split(".", 1)[1]: g[k]
                        for k in (
                            "engine.peak_update_bytes",
                            "engine.client_chunks",
                            "engine.chunk_size",
                            "engine.streaming",
                        )
                    }
    return {}


def memory_records(log_path):
    """The run's ``memory`` records (a card run writes one a program,
    ``telemetry/profiling.py:record_program_profile``; none on the CPU)."""
    with open(os.path.join(log_path, "telemetry.jsonl")) as f:
        return [r for r in map(json.loads, f) if r.get("t") == "memory"]


def main(argv: Optional[List[str]] = None) -> dict:
    apply_numerics()
    ap = argparse.ArgumentParser(description="dense against streaming update memory")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--out", default="outputs/streaming_clients")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (the default)")
    args = ap.parse_args(argv)

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    engines, report = {}, {}
    for mode, streaming in (("dense", False), ("streaming", True)):
        ds = Synthetic(num_clients=args.clients, train_size=40 * args.clients, test_size=200,
                       noise=0.3, cache=False, seed=0)
        sim = Simulator(
            ds,
            aggregator="trimmedmean",
            aggregator_kws={"num_byzantine": 2},
            attack="signflipping",
            num_byzantine=2,
            log_path=os.path.join(args.out, mode),
            seed=42,
            device=args.device,
        )
        sim.run(
            "mlp",
            global_rounds=args.rounds,
            local_steps=2,
            client_lr=0.5,
            validate_interval=args.rounds,
            # 5 does not divide 24: the engine ceil-sizes and zero-pads the
            # last chunk
            client_chunks=5,
            streaming=streaming,
        )
        gauges = memory_gauges(os.path.join(args.out, mode))
        engines[mode] = sim.engine
        report[mode] = {"gauges": gauges,
                        "memory": memory_records(os.path.join(args.out, mode))}
        mb = gauges["peak_update_bytes"] / 1e6
        print(
            f"[{mode:9s}] peak_update_bytes={gauges['peak_update_bytes']:.0f}"
            f" ({mb:.1f} MB), chunks={gauges['client_chunks']},"
            f" chunk_size={gauges['chunk_size']},"
            f" streaming={bool(gauges['streaming'])}"
        )

    dense_peak = engines["dense"].peak_update_bytes
    stream_peak = engines["streaming"].peak_update_bytes
    assert stream_peak < dense_peak, (dense_peak, stream_peak)
    print(
        f"update-memory ratio dense/streaming = {dense_peak / stream_peak:.1f}x"
        f" (chunk-independent of K: grows only with chunk_size * D)"
    )
    return report


if __name__ == "__main__":
    main()
