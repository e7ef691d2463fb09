"""Simulation-service command line: start / submit / status / result /
metrics / drain, one JSON line each.

Counterpart: ``scripts/serve.py``. Usage::

    # the server (blocks until drained; exit 0 after a clean drain), on
    # the card, or on the CPU with --device cpu; supervised for the whole
    # crash story:
    python -m blades_tpu_torch.supervision --heartbeat-timeout 300 -- \\
        python -m blades_tpu_torch.examples.serve start --out results/service_torch

    python -m blades_tpu_torch.examples.serve submit --socket S --request '{"kind": ...}'
    python -m blades_tpu_torch.examples.serve submit --socket S --request @req.json --no-wait
    python -m blades_tpu_torch.examples.serve result --socket S --id req-... [--wait 120]
    python -m blades_tpu_torch.examples.serve status --socket S
    python -m blades_tpu_torch.examples.serve metrics --socket S
    python -m blades_tpu_torch.examples.serve drain --socket S

``start`` follows ``BLADES_RESUME=1`` (a supervisor's relaunch): the
spool's pending requests are requeued and run only their unjournaled
cells. ``--device cuda|cpu`` (default ``cuda``) takes the place of the
JAX command's ``--devices N``: where ``simulate`` cells and sweeps run; a
``cuda`` server without CUDA fails those cells (probe cells run
anywhere). ``--workers N`` runs requests in N worker processes, each
given the server's ``--device`` (``--workers 2 --device cpu`` on a machine
without a card); ``--cell-deadline`` is then enforced by the parent, which
kills a worker's process group. The socket is ``<out>/service.sock``
unless ``--socket`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

METRIC = "service"


def _load_request(raw: str) -> dict:
    if raw.startswith("@"):
        with open(raw[1:]) as fh:
            raw = fh.read()
    req = json.loads(raw)
    if not isinstance(req, dict):
        raise ValueError("request must be a JSON object")
    return req


def _start(args) -> int:
    from blades_tpu_torch.service.server import SimulationService
    from blades_tpu_torch.telemetry import context

    context.activate(fresh=True)
    svc = SimulationService(
        args.out,
        socket_path=args.socket,
        max_queue=args.max_queue,
        tenant_quota=args.tenant_quota,
        attempts=args.attempts,
        base_delay_s=args.base_delay,
        cell_deadline_s=args.cell_deadline,
        health_interval_s=args.health_interval,
        workers=args.workers,
        device=args.device,
    )
    snap = svc.serve()
    print(json.dumps({
        "metric": METRIC,
        "out": args.out,
        "socket": svc.socket_path,
        "resumed_start": svc.resume,
        "device": svc.device,
        **{k: v for k, v in snap.items() if k != "pid"},
        "ok": True,
    }))
    return 0


def _client(args):
    from blades_tpu_torch.service.client import ServiceClient

    return ServiceClient(args.socket, timeout=args.timeout)


def _submit(args) -> int:
    request = _load_request(args.request)
    if args.id:
        request["id"] = args.id
    reply = _client(args).submit(request, wait=not args.no_wait, client=args.client,
                                 priority=args.priority, deadline_s=args.deadline)
    print(json.dumps({"metric": f"{METRIC}_submit", **reply}))
    return 0 if reply.get("ok") else 1


def _result(args) -> int:
    client = _client(args)
    reply = client.wait_result(args.id, timeout=args.wait) if args.wait else client.result(args.id)
    print(json.dumps({"metric": f"{METRIC}_result", **reply}))
    return 0 if reply.get("ok") and reply.get("status") == "done" else 1


def _simple(op):
    def run(args) -> int:
        reply = getattr(_client(args), op)()
        print(json.dumps({"metric": f"{METRIC}_{op}", **reply}))
        return 0 if reply.get("ok") else 1
    return run


def _run(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("start", help="run the server until drained")
    ps.add_argument("--out", default=os.path.join(REPO, "results", "service_torch"))
    ps.add_argument("--socket", default=None, help="socket path (default <out>/service.sock)")
    ps.add_argument("--max-queue", type=int, default=8)
    ps.add_argument("--tenant-quota", type=int, default=None,
                    help="a tenant's queued-request cap (default: the global --max-queue only)")
    ps.add_argument("--attempts", type=int, default=2, help="a cell's retry budget")
    ps.add_argument("--cell-deadline", type=float, default=None,
                    help="a cell's soft deadline in seconds")
    ps.add_argument("--base-delay", type=float, default=0.5)
    ps.add_argument("--health-interval", type=float, default=30.0)
    ps.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where simulate cells and sweeps run (default cuda)")
    ps.add_argument("--workers", type=int, default=0,
                    help="worker-process pool size (0: requests run in the server)")
    ps.set_defaults(func=_start)

    for name, func, extra in (
        ("submit", _submit, "request"),
        ("result", _result, "id"),
        ("status", _simple("status"), None),
        ("metrics", _simple("metrics"), None),
        ("drain", _simple("drain"), None),
    ):
        pc = sub.add_parser(name)
        pc.add_argument("--socket", required=True)
        pc.add_argument("--timeout", type=float, default=120.0)
        if extra == "request":
            pc.add_argument("--request", required=True, help="request JSON (or @file)")
            pc.add_argument("--id", default=None)
            pc.add_argument("--no-wait", action="store_true")
            pc.add_argument("--client", default=None, help="tenant label (fair share and quota)")
            pc.add_argument("--priority", default=None, choices=("interactive", "normal", "batch"))
            pc.add_argument("--deadline", type=float, default=None,
                            help="deadline in seconds for deadline-aware admission")
        elif extra == "id":
            pc.add_argument("--id", required=True)
            pc.add_argument("--wait", type=float, default=None,
                            help="poll until done for up to this many seconds")
        pc.set_defaults(func=func)

    args = p.parse_args(argv)
    return args.func(args)


def main(argv: Optional[list] = None) -> int:
    """One JSON line whatever happens, an error included."""
    try:
        return _run(argv)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001 - the one-line contract is the catch-all
        print(json.dumps({"metric": METRIC, "ok": False,
                          "error": f"{type(e).__name__}: {e}"[:1000]}))
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
