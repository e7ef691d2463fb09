"""The service's pure-Python parts (``blades_tpu_torch/service/protocol.py``,
``handlers.py``'s request validation, ``spool.py``, ``scheduler.py``,
``telemetry/reqpath.py``) against the JAX package's on the same inputs.

They are copies, so they must agree exactly: the wire bytes of a message,
the cells, counts and ``ValueError`` messages of a table of requests, the
spool's pending list, counts and lines (``ts`` dropped) after the same
admissions and completions, the scheduler's picks, snapshots and
admission verdicts over seeded operation sequences (hypothesis), and the
histograms' percentiles and the registry's snapshots for the same
observations under one injected clock. The registry is given each
package's own build counters: XLA's compile counters on the JAX side,
the port's ``engine.*`` / ``cuda.*`` ones on the other.
"""

import io
import json
import os
import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from blades_tpu.service import handlers as jhandlers
from blades_tpu.service import protocol as jprotocol
from blades_tpu.service import scheduler as jscheduler
from blades_tpu.service.spool import RequestSpool as JSpool
from blades_tpu.telemetry import reqpath as jreqpath
from blades_tpu_torch.service import handlers as handlers
from blades_tpu_torch.service import protocol as protocol
from blades_tpu_torch.service import scheduler as scheduler
from blades_tpu_torch.service.spool import RequestSpool
from blades_tpu_torch.telemetry import reqpath
from torch_threads_helpers import torch_threads_per_worker  # noqa: F401

MESSAGES = [
    {"op": "ping"},
    {"op": "submit", "request": {"kind": "probe", "cells": [{"label": "a", "op": "ok",
                                                             "value": 1.5}]}, "wait": False},
    {"op": "result", "id": "req-x"},
    {"text": "ünïcode — ☃", "nested": {"a": [1, None, True, 2.0e-9]}},
    {},
]


@pytest.mark.parametrize("msg", MESSAGES, ids=range(len(MESSAGES)))
def test_protocol_frames_equal_bytes_and_read_back(msg):
    ours, theirs = io.BytesIO(), io.BytesIO()
    protocol.write_message(ours, msg)
    jprotocol.write_message(theirs, msg)
    assert ours.getvalue() == theirs.getvalue()
    assert protocol.read_message(io.BytesIO(theirs.getvalue())) == msg
    assert jprotocol.read_message(io.BytesIO(ours.getvalue())) == msg


def _read_error(mod, raw):
    try:
        mod.read_message(io.BytesIO(raw))
    except mod.ProtocolError as e:
        return str(e)
    return None


@pytest.mark.parametrize("raw", [b"", b"not json\n", b"[1, 2]\n", b"\xff\xfe\n",
                                 b"{" + b" " * (8 * 1024 * 1024 + 2) + b"}\n"],
                         ids=["eof", "garbage", "array", "utf8", "oversized"])
def test_protocol_read_errors_equal(raw):
    assert _read_error(protocol, raw) == _read_error(jprotocol, raw)


def test_protocol_constants_ids_and_socket_path_equal():
    assert protocol.MAX_MESSAGE_BYTES == jprotocol.MAX_MESSAGE_BYTES
    assert protocol.DEFAULT_SOCKET_NAME == jprotocol.DEFAULT_SOCKET_NAME
    shape = re.compile(r"^req-\d{8}T\d{6}-[0-9a-f]{8}$")
    assert shape.match(protocol.mint_request_id()) and shape.match(jprotocol.mint_request_id())
    for args in (("/o",), ("/o", "/s.sock"), ("rel/dir", None)):
        assert protocol.socket_path_for(*args) == jprotocol.socket_path_for(*args)
    big = {"x": "y" * protocol.MAX_MESSAGE_BYTES}
    for mod in (protocol, jprotocol):
        with pytest.raises(mod.ProtocolError, match="exceeds"):
            mod.write_message(io.BytesIO(), big)


REQUESTS = [
    {"kind": "probe", "cells": [{"label": "a", "op": "ok"}, {"op": "fail"}]},
    {"kind": "simulate", "cells": [{"agg": "mean", "rounds": 1}, {"label": "x.y-1"}]},
    {"kind": "probe", "cells": [{"label": "", "op": "ok"}]},
    {"kind": "nope", "cells": [{}]},
    {"cells": [{}]},
    {"kind": "probe"},
    {"kind": "probe", "cells": []},
    {"kind": "probe", "cells": "abc"},
    {"kind": "probe", "cells": [1]},
    {"kind": "probe", "cells": [{"label": "a"}, {"label": "a"}]},
    {"kind": "probe", "cells": [{"label": "../etc"}]},
    {"kind": "probe", "cells": [{"label": "/abs"}]},
    {"kind": "probe", "cells": [{"label": "x" * 121}]},
    {"kind": "sweep", "sweep": "chaos", "spec": {"scenarios": 3}},
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("request_", REQUESTS, ids=range(len(REQUESTS)))
def test_build_and_estimate_cells_equal(request_):
    assert _outcome(handlers.build_cells, request_) == _outcome(jhandlers.build_cells, request_)
    assert handlers.estimate_cells(request_) == jhandlers.estimate_cells(request_)


@pytest.mark.parametrize("spec", [
    {}, {"quick": True, "clients": 6, "aggs": ["mean", "median"]}, {"no_async": True},
    {"clients": 9, "tau_max": 2}, {"bogus": 1}, {"clients": 1}, None,
], ids=range(7))
def test_sweep_estimates_equal(spec):
    for driver in ("certify", "chaos", "nope"):
        req = {"kind": "sweep", "sweep": driver, "spec": spec}
        assert handlers.estimate_cells(req) == jhandlers.estimate_cells(req)
    req = {"kind": "sweep", "sweep": "chaos", "spec": {"scenarios": 5}}
    assert handlers.estimate_cells(req) == jhandlers.estimate_cells(req) == 5


@pytest.mark.parametrize("value", ["a", "A-1.b_c", "0", "-a", ".hidden", "a/b", "..", "",
                                   "x" * 120, "x" * 121, 7, None, "sp ace"])
def test_safe_name_equal(value):
    assert (_outcome(handlers.safe_name, value, "cell label")
            == _outcome(jhandlers.safe_name, value, "cell label"))


def test_request_kinds_and_drivers_equal():
    assert handlers.REQUEST_KINDS == jhandlers.REQUEST_KINDS
    assert handlers.SWEEP_DRIVERS == jhandlers.SWEEP_DRIVERS
    assert handlers._SIM_DEFAULTS == jhandlers._SIM_DEFAULTS


def _lines(path):
    out = []
    for line in open(path):
        rec = json.loads(line)
        rec.pop("ts")
        out.append(rec)
    return out


SPOOL_OPS = [("admit", {"kind": "probe", "cells": [{"label": "a"}]}, "r1"),
             ("admit", {"kind": "simulate", "cells": [{}]}, "r2"),
             ("complete", "r1", {"ok": True, "cells": [1, 2]}),
             ("admit", {"kind": "probe", "cells": [{"label": "b"}]}, "r3"),
             ("admit", {"kind": "probe", "cells": [{"label": "b2"}]}, "r1"),
             ("complete", "r3", {"ok": False, "error": "x"})]


@pytest.mark.parametrize("steps", [2, 3, 6])
def test_spool_sequences_equal(tmp_path, steps):
    spools = (RequestSpool(str(tmp_path / "p.jsonl")), JSpool(str(tmp_path / "j.jsonl")))
    for op, a, b in SPOOL_OPS[:steps]:
        for sp in spools:
            if op == "admit":
                sp.admit(a, request_id=b)
            else:
                sp.complete(a, b)
    ours, theirs = spools
    assert ours.pending() == theirs.pending() and ours.counts() == theirs.counts()
    assert len(ours) == len(theirs)
    for sp in spools:
        sp.close()
    assert _lines(ours.path) == _lines(theirs.path)
    # a resume of each file by the other package's spool sees the same
    again = (RequestSpool(theirs.path, resume=True), JSpool(ours.path, resume=True))
    assert again[0].pending() == again[1].pending() == ours.pending()
    assert again[0].counts() == again[1].counts() == ours.counts()
    assert again[0].reply("r1") == again[1].reply("r1")
    for sp in again:
        sp.close()


def test_spool_torn_tail_tolerated_and_fresh_start_truncates(tmp_path):
    path = str(tmp_path / "s.jsonl")
    sp = RequestSpool(path)
    sp.admit({"kind": "probe", "cells": [{}]}, request_id="a")
    sp.admit({"kind": "probe", "cells": [{}]}, request_id="b")
    sp.complete("a", {"ok": True})
    sp.close()
    with open(path, "a") as fh:
        fh.write('{"kind": "done", "id": "b", "re')  # a writer killed mid-append
    ours, theirs = RequestSpool(path, resume=True), JSpool(path, resume=True)
    assert ours.resumed and theirs.resumed
    assert [rid for rid, _ in ours.pending()] == [rid for rid, _ in theirs.pending()] == ["b"]
    assert ours.counts() == theirs.counts() == {"admitted": 2, "done": 1, "pending": 1}
    ours.close()
    theirs.close()
    fresh = RequestSpool(path)
    assert not fresh.resumed and not os.path.exists(path) and fresh.counts()["admitted"] == 0


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


TENANTS = ("t0", "t1", "flood")
AFFINITIES = (None, "fa", "fb")

_op = st.one_of(
    st.tuples(st.just("put"), st.sampled_from(TENANTS), st.sampled_from(scheduler.PRIORITIES),
              st.sampled_from(AFFINITIES),
              st.one_of(st.none(), st.floats(0.0, 5.0, allow_nan=False))),
    st.tuples(st.just("pick"), st.booleans()),
    st.tuples(st.just("charge"), st.sampled_from(TENANTS), st.floats(0.0, 3.0)),
    st.tuples(st.just("requeue"), st.booleans()),
    st.tuples(st.just("done")),
    st.tuples(st.just("overflow"), st.sampled_from(TENANTS)),
    st.tuples(st.just("warm"), st.sampled_from(AFFINITIES)),
    st.tuples(st.just("tick"), st.floats(0.0, 2.0)),
)


def _drive_scheduler(mod, ops, max_queue, quota):
    clock = FakeClock()
    s = mod.TenantScheduler(max_queue=max_queue, tenant_quota=quota,
                            weights={"t1": 2.0}, clock=clock)
    out, picked, n = [], [], 0
    for op in ops:
        kind = op[0]
        if kind == "put":
            n += 1
            s.put(mod.ScheduledRequest(request_id=f"r{n}", request={}, tenant=op[1],
                                       priority=op[2], affinity=op[3], est_s=op[4]))
        elif kind == "pick":
            e = s.pick(timeout=0, warm_only=False)
            out.append(("pick", e and (e.request_id, e.preemptions)))
            if e is not None:
                picked.append(e)
        elif kind == "charge":
            s.charge(op[1], op[2])
        elif kind == "requeue" and picked:
            s.requeue(picked.pop(), preempted=op[1])
        elif kind == "done" and picked:
            s.done(picked.pop(0))
        elif kind == "overflow":
            out.append(("overflow", s.overflow(op[1])))
        elif kind == "warm":
            s.note_warm(op[1])
        elif kind == "tick":
            clock.advance(op[1])
        out.append(("snap", s.qsize(), s.empty(), s.depth_by_class(), s.composition(),
                    [s.backlog_s(p) for p in mod.PRIORITIES],
                    [s.waiting_above(p) for p in mod.PRIORITIES],
                    [s.is_warm(a) for a in AFFINITIES]))
    return out


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_op, max_size=40), max_queue=st.integers(1, 6),
       quota=st.one_of(st.none(), st.integers(1, 3)))
def test_scheduler_sequences_equal(ops, max_queue, quota):
    assert (_drive_scheduler(scheduler, ops, max_queue, quota)
            == _drive_scheduler(jscheduler, ops, max_queue, quota))


def test_priority_rank_equal():
    assert scheduler.PRIORITIES == jscheduler.PRIORITIES
    for p in scheduler.PRIORITIES:
        assert scheduler.priority_rank(p) == jscheduler.priority_rank(p)
    for mod in (scheduler, jscheduler):
        with pytest.raises(ValueError, match="unknown priority 'urgent'"):
            mod.priority_rank("urgent")


_history = st.fixed_dictionaries({
    "done": st.integers(0, 20), "execute_s": st.floats(0.0, 50.0),
    "build_s": st.floats(0.0, 10.0), "cold": st.integers(0, 4),
    "builds": st.lists(st.one_of(st.none(), st.floats(0.0, 5.0)), max_size=4),
})


@settings(max_examples=80, deadline=None)
@given(h=_history, cells=st.integers(0, 12),
       deadline=st.one_of(st.none(), st.floats(0.01, 60.0)),
       backlog=st.floats(0.0, 30.0), warm=st.booleans())
def test_cost_estimator_verdicts_equal(h, cells, deadline, backlog, warm):
    snap = {"cells": {"done": h["done"]}, "requests": {"cold": h["cold"]},
            "split": {"execute_s": h["execute_s"], "build_s": h["build_s"]}}
    stats = {"by_key": {f"k{i}": {"build_s": b} for i, b in enumerate(h["builds"])}}
    verdicts = [mod.CostEstimator(lambda: snap, lambda: stats).verdict(
        cells, deadline, backlog_s=backlog, warm=warm) for mod in (scheduler, jscheduler)]
    assert verdicts[0] == verdicts[1]
    empty = [mod.CostEstimator(lambda: None, lambda: None).verdict(cells, deadline)
             for mod in (scheduler, jscheduler)]
    assert empty[0] == empty[1]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(-1.0, 20000.0, allow_nan=False), max_size=60))
def test_histogram_percentiles_equal(values):
    ours, theirs = reqpath.Histogram(), jreqpath.Histogram()
    assert ours.EDGES == theirs.EDGES
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.to_dict() == theirs.to_dict()


def test_histogram_nan_and_edges_equal():
    for values in ([float("nan"), -3.0], [0.001, 0.002, 0.005, 10000.0, 10001.0]):
        ours, theirs = reqpath.Histogram(), jreqpath.Histogram()
        for v in values:
            ours.observe(v)
            theirs.observe(v)
        assert ours.to_dict() == theirs.to_dict()


_life = st.lists(st.tuples(
    st.sampled_from(["a", "b"]), st.sampled_from(["probe", "simulate"]),
    st.sampled_from(scheduler.PRIORITIES), st.floats(0.0, 3.0), st.floats(0.0, 5.0),
    st.integers(0, 3), st.floats(0.0, 2.0), st.sampled_from(["ok", "error", "quarantined",
                                                             "reject", "never"]),
    st.integers(0, 3)), max_size=12)


def _drive_registry(mod, life, counts_key, seconds_key):
    clock = FakeClock()
    reg = mod.MetricsRegistry(clock=clock)
    built = {counts_key: 0.0, seconds_key: 0.0}
    out = []
    for i, (client, op, prio, wait, run, builds, build_s, outcome, cells) in enumerate(life):
        rid = f"r{i}"
        if outcome == "reject":
            reg.reject("backpressure", op=op, client=client)
            continue
        path = reg.admit(rid, op=op, client=client, priority=prio)
        path.stamp("spooled")
        path.stamp("queued")
        reg.queue_depth(i % 4, by_class={prio: i % 3})
        clock.advance(wait)
        if outcome == "never":
            out.append(reg.finish(rid, outcome="error"))
            continue
        path.start(counters=dict(built))
        for _ in range(cells):
            reg.cell(rid)
        if i % 3 == 1:
            reg.preempted(rid)
        built[counts_key] += builds
        built[seconds_key] += min(build_s, run) if builds else 0.0
        clock.advance(run)
        out.append(reg.finish(rid, outcome=outcome, retried=cells % 2,
                              quarantined_cells=int(outcome == "quarantined"),
                              counters=dict(built)))
        reg.admission(["estimated", "no_estimate", "infeasible"][i % 3])
    out.append(reg.snapshot())
    out.append(reg.get("r0") is None)
    return out


@settings(max_examples=50, deadline=None)
@given(_life)
def test_registry_snapshots_equal(life):
    """The same lifecycles with each package's build counters: the split,
    warm/cold, histograms and tables agree."""
    assert (_drive_registry(reqpath, life, "engine.builds", "engine.build_s")
            == _drive_registry(jreqpath, life, "xla.compiles", "xla.compile_s"))


def test_the_ports_build_counters_make_a_request_cold():
    """Each of the port's three build sources makes a request cold; none
    keeps it warm with build_s 0; the split tiles total_s."""
    for key in (("cuda.kernel_builds", "cuda.kernel_build_s"),
                ("cuda.graph_captures", "cuda.graph_capture_s"),
                ("engine.builds", "engine.build_s")):
        clock = FakeClock()
        path = reqpath.RequestPath("r", clock=clock)
        clock.advance(1.0)
        path.start(counters={})
        clock.advance(2.0)
        split = path.finish(counters={key[0]: 1, key[1]: 0.5})
        assert split["warm"] is False and split["compiles"] == 1 and split["build_s"] == 0.5
        assert abs(split["queue_wait_s"] + split["build_s"] + split["execute_s"]
                   - split["total_s"]) < 1e-9
    path = reqpath.RequestPath("w", clock=FakeClock())
    path.start(counters={"engine.builds": 2.0, "cuda.kernel_reuses": 1})
    split = path.finish(counters={"engine.builds": 2.0, "cuda.kernel_reuses": 4})
    assert split["warm"] is True and split["build_s"] == 0.0 and split["compiles"] == 0


def test_build_counters_add_the_cache_totals():
    from blades_tpu_torch.sweeps import EngineCache

    cache = EngineCache()
    assert reqpath.build_counters(cache)["engine.builds"] == 0
    cache.put("k", object(), build_s=0.25)
    cache.put("k2", object())
    counters = reqpath.build_counters(cache)
    assert counters["engine.builds"] == 1 and counters["engine.build_s"] == 0.25
    assert "engine.builds" not in reqpath.build_counters(None)
