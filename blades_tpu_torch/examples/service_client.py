"""Simulation service: submit experiments to a warm, crash-tolerant server.

Counterpart: ``examples/service_client.py``. Starts the port's service
(``examples/serve.py``) as a subprocess, then drives it over its unix
socket:

1. a ``probe`` request (stdlib cells: the server has not imported torch
   yet), then one with a tenant label, a priority class and a deadline
   (``service/scheduler.py``);
2. a ``probe`` request with a poison cell, quarantined with its error
   while its sibling completes;
3. two identical ``simulate`` requests: federated rounds on the seeded
   synthetic dataset; the second is served from the warm ``EngineCache``
   (no engine, kernel or graph build: ``warm`` in the metrics) and returns
   the same results;
4. ``op: status`` and ``op: metrics`` (warm and cold counts, the queue
   wait / build / execute split, ``telemetry/reqpath.py``), then a drain:
   the server finishes what it admitted and exits 0.

Run it on the card, or on the CPU with ``--device cpu``::

    python -m blades_tpu_torch.examples.service_client --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "outputs", "service_demo_torch"))
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    from blades_tpu_torch.service.client import ServiceClient
    from blades_tpu_torch.service.protocol import socket_path_for

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [q for q in env.get("PYTHONPATH", "").split(
        os.pathsep) if q])
    server = subprocess.Popen(
        [sys.executable, "-m", "blades_tpu_torch.examples.serve", "start", "--out", args.out,
         "--device", args.device, "--base-delay", "0.1"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    client = ServiceClient(socket_path_for(args.out), timeout=600, connect_retries=50,
                           connect_delay_s=0.2)
    try:
        _drive(client, args)
        print("drain ->", json.dumps(client.drain()))
        out, _ = server.communicate(timeout=120)
        print("server exit:", server.returncode)
        print("server summary:", out.strip())
    finally:
        # a failure above must not leave a server holding the socket
        if server.poll() is None:
            server.kill()
            server.communicate()


def _drive(client, args) -> None:
    print("ping ->", json.dumps(client.ping()))

    probe = client.submit({"kind": "probe", "cells": [{"label": "hello", "op": "ok",
                                                       "value": 42}]})
    print("probe ->", json.dumps(probe["cells"]))

    tenant = client.submit({"kind": "probe", "cells": [{"label": "urgent", "op": "ok",
                                                        "value": 7}]},
                           client="alice", priority="interactive", deadline_s=30.0)
    print("tenant probe ->", json.dumps(tenant["cells"]))

    poison = client.submit({"kind": "probe", "cells": [
        {"label": "good", "op": "ok", "value": 1},
        {"label": "bad", "op": "fail", "message": "intentionally poisoned"},
    ]})
    bad = next(c for c in poison["cells"] if c["label"] == "bad")
    good = next(c for c in poison["cells"] if c["label"] == "good")
    print(f"poison -> bad quarantined ({bad['error_type']}), "
          f"good served: {json.dumps(good['result'])}")

    simulate = {"kind": "simulate", "cells": [
        {"label": "mean", "agg": "mean", "rounds": args.rounds, "seed": 11},
        {"label": "median", "agg": "median", "rounds": args.rounds, "seed": 11},
    ]}
    cold = client.submit(simulate, timeout=600)
    warm = client.submit(simulate, timeout=600)
    print("simulate (cold) ->", json.dumps(cold["cells"]))
    print("warm repeat bit-identical:", cold["cells"] == warm["cells"])

    status = client.status()
    print("status -> served={served} rejected={rejected} "
          "quarantined_requests={quarantined_requests}".format(**status))

    metrics = client.metrics()
    split = metrics["split"]
    print("metrics -> warm={warm} cold={cold}".format(**metrics["requests"]))
    print(f"metrics -> queue_wait_share={split['queue_wait_share']}, "
          f"warm p99 <= {metrics['latency']['warm'].get('p99_s')}s")
    print("metrics -> sched =", json.dumps(metrics["sched"]))


if __name__ == "__main__":
    main()
