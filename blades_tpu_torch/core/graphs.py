"""Round blocks on the card: one round captured as a CUDA graph and
replayed round after round.

Counterpart: ``blades_tpu/core/engine.py:1177-1279`` (``_build_block``,
``run_block``), where ``lax.scan`` runs R rounds as one XLA program with no
host round-trip. PyTorch's counterpart of one program is a CUDA graph: the
round's few hundred (MLP) to few thousand (CCT-2) launches are recorded
once and each replay is one launch from the host.

An engine keeps one :class:`RoundGraph` (``RoundEngine.last_graph``): a
graph holds a round's peak reserved in its private memory pool, so a new
batch source, state layout or fault-model program drops the old graph
before the new one is captured. A :class:`RoundGraph` holds, for one
engine and one batch source (a sampler, or a batch shape):

- static buffers: a private copy of every tensor of the ``RoundState``,
  which the captured round reads and writes its new state back into; the
  round's :class:`~blades_tpu_torch.core.engine.RoundInputs` (the learning
  rates and the round index, 0-d tensors filled before each replay); and,
  without a sampler, the batch, copied in before each replay;
- the round's generators, one ``utils/rng.py:RoundStreams`` (the audit
  fallback's copy of the ``AGG`` generator among them), registered
  with the graph (``CUDAGraph.register_generator_state``) and reseeded on
  the host before each replay: ``manual_seed`` sets the seed and puts the
  Philox offset at 0, and the replay reads both, so it draws what a new
  generator at that node draws in the eager round;
- the round's outputs (metrics; the defense's diagnostics, the fault
  counters, the audit's fields, the metric pack and the async counters
  where they are on), packed in the graph into one vector per dtype, whose
  values each replay copies into its row of the block's ``[R, n]`` buffers.

The first round run through a new graph runs eagerly on a side stream.
That is PyTorch's warm-up before capture (cuBLAS and cuDNN pick their
algorithms and workspaces, the trimmed-mean kernel sets its attributes,
lazily built device tables are built), and it is the block's first round,
not a wasted one. Then the allocator's cache is emptied and the round is
captured on that stream under ``torch.cuda.set_sync_debug_mode("error")``.
A capture that fails raises: the engine called this configuration
graph-safe (``RoundEngine.graph_block_reason``), and there is no eager
fallback for it.

Launch counts: a wrapper counts its kernel where it launches it, in
Python, and a replay runs no Python. The launches counted during the
capture (which launches nothing) are taken back and added once per replay,
so ``ops/trimmed.py:trimmed_mean_launches`` counts the kernel's real runs.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from blades_tpu_torch.ops import trimmed
from blades_tpu_torch.telemetry.recorder import count_process
from blades_tpu_torch.utils import rng


def _tensor_pairs(dst, src, out: list, path: str = "state") -> list:
    """``(dst leaf, src leaf)`` for every tensor of ``dst``, matched by key
    and position, with ``src`` of the same shape and dtype; other leaves
    (the host ``round_idx``) are skipped."""
    if isinstance(dst, torch.Tensor):
        if (not isinstance(src, torch.Tensor) or src.shape != dst.shape
                or src.dtype != dst.dtype):
            raise RuntimeError(
                f"a captured round must keep its state's layout: {path} is "
                f"{tuple(dst.shape)} {dst.dtype}, the round gave "
                f"{getattr(src, 'shape', src)!r} {getattr(src, 'dtype', '')}"
            )
        out.append((dst, src))
    elif isinstance(dst, dict):
        if not isinstance(src, dict) or set(dst) != set(src):
            raise RuntimeError(f"a captured round changed the keys of {path}")
        for key in dst:
            _tensor_pairs(dst[key], src[key], out, f"{path}[{key!r}]")
    elif isinstance(dst, (tuple, list)):
        if not isinstance(src, (tuple, list)) or len(dst) != len(src):
            raise RuntimeError(f"a captured round changed the length of {path}")
        for i, (a, b) in enumerate(zip(dst, src)):
            _tensor_pairs(a, b, out, f"{path}[{i}]")
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def write_back(static, new) -> None:
    """Copy every tensor of the state ``new`` into its buffer in ``static``.
    A new leaf that is another static buffer, or a view of one (a state
    entry handed on unchanged under another name), is cloned first, so no
    copy reads a buffer an earlier copy of the same round has overwritten."""
    pairs = _tensor_pairs(static, new, [])
    statics = {_storage(d) for d, _ in pairs}
    pairs = [(d, s if s is d or _storage(s) not in statics else s.clone())
             for d, s in pairs]
    for d, s in pairs:
        if s is not d:
            d.copy_(s)


def _clone_state(state, device=None):
    """A copy of every tensor of ``state`` (on ``device`` when given)."""
    return tree_map(lambda t: t.to(device or t.device, copy=True)
                    if isinstance(t, torch.Tensor) else t, state)


def state_signature(state) -> tuple:
    """The layout of a state's tensors: its keys, shapes and dtypes."""
    leaves, spec = tree_flatten(state)
    return (str(spec), tuple((tuple(t.shape), t.dtype) for t in leaves
                             if isinstance(t, torch.Tensor)))


class _Packer:
    """A round's outputs (a pytree of tensors of fixed shapes, e.g. 0-d
    metrics and ``[K]`` trim counts, and Nones) as one vector per dtype,
    and back as ``[R, *shape]`` tensors from ``[R, n]`` rows."""

    def __init__(self, outs):
        leaves, self.spec = tree_flatten(outs)
        # per leaf: None, or (dtype, offset into its dtype's vector, shape)
        self.slots: List[Optional[tuple]] = []
        sizes: Dict[torch.dtype, int] = {}
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                at = sizes.get(leaf.dtype, 0)
                self.slots.append((leaf.dtype, at, tuple(leaf.shape)))
                sizes[leaf.dtype] = at + leaf.numel()
            elif leaf is None:
                self.slots.append(None)
            else:
                raise RuntimeError(f"a captured round output {leaf!r}, not a tensor")
        self.sizes = sizes

    def pack(self, outs) -> Dict[torch.dtype, torch.Tensor]:
        leaves, _ = tree_flatten(outs)
        groups: Dict[torch.dtype, list] = {dt: [] for dt in self.sizes}
        for leaf, slot in zip(leaves, self.slots):
            if slot is not None:
                groups[slot[0]].append(leaf.reshape(-1))
        return {dt: torch.cat(vals) for dt, vals in groups.items()}

    def rows(self, r: int, device) -> Dict[torch.dtype, torch.Tensor]:
        return {dt: torch.empty((r, n), dtype=dt, device=device) for dt, n in self.sizes.items()}

    def unpack(self, rows: Dict[torch.dtype, torch.Tensor]):
        leaves = []
        for slot in self.slots:
            if slot is None:
                leaves.append(None)
                continue
            dt, at, shape = slot
            n = 1
            for dim in shape:
                n *= dim
            block = rows[dt][:, at:at + n]
            leaves.append(block.reshape((block.shape[0],) + shape))
        return tree_unflatten(leaves, self.spec)


class RoundGraph:
    """One engine's round captured once and replayed (module docstring).
    ``sampler``: the fused batch source, ``generator -> (cx, cy)``; None
    replays a round on the static batch buffers shaped as ``batch``."""

    def __init__(self, engine, state, key, sampler=None, batch=None):
        dev = engine.device
        # no reference back to the engine: dropping the engine frees its
        # graph at once, never in a garbage collection during a capture
        self.device, self.key, self.sampler = dev, key, sampler
        self.streams = rng.RoundStreams(0, 0, dev)
        self.inputs = engine._inputs(0.0, 0.0, 0)
        self.state = _clone_state(state, dev)
        self.batch = None if sampler is not None else [torch.empty_like(t) for t in batch]
        # every object whose device tensors the captured round reads stays
        # alive with the graph, even if the engine is rebound
        self._keep = (engine.attack, engine.aggregator, engine.fault_model, engine.audit_monitor,
                      engine.async_config, sampler)
        self.stream = torch.cuda.Stream(dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.packer: Optional[_Packer] = None
        self.out_vecs: Dict[torch.dtype, torch.Tensor] = {}
        #: trimmed-mean launches recorded in the graph (added per replay)
        self.kernel_launches = 0
        #: wall seconds of the capture, and of the eager warm-up round
        self.capture_seconds: Optional[float] = None
        self.warmup_seconds: Optional[float] = None
        self.replays = 0

    def _body(self, eng):
        """The round on the static buffers: sample (or take the static
        batch), run the engine's round body, write the new state back."""
        if self.sampler is not None:
            batch = list(self.sampler(self.streams(rng.DATA)))
        else:
            batch = list(self.batch)
        new_state, metrics = eng._round(self.state, batch, self.inputs, self.streams)
        write_back(self.state, new_state)
        return eng.round_outputs(metrics)

    def _set_inputs(self, spec, batch) -> None:
        self.streams.reseed(spec.seed, spec.round_idx, spec.data_round)
        self.inputs.client_lr.fill_(spec.client_lr)
        self.inputs.server_lr.fill_(spec.server_lr)
        self.inputs.round_t.fill_(spec.round_idx)
        if batch is not None:
            for dst, src in zip(self.batch, batch):
                dst.copy_(src)

    def _warm_up(self, eng) -> Dict[torch.dtype, torch.Tensor]:
        """The eager first round on the capture stream; its packed outputs."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            outs = self._body(eng)
            self.packer = _Packer(outs)
            vecs = self.packer.pack(outs)
            del outs
        main.wait_stream(self.stream)
        for vec in vecs.values():  # read on the main stream below
            vec.record_stream(main)
        torch.cuda.synchronize(self.device)
        self.warmup_seconds = time.perf_counter() - t0
        return vecs

    def _capture(self, eng) -> None:
        t0 = time.perf_counter()
        eng.last_updates = None
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for gen in self.streams.generators():
            graph.register_generator_state(gen)
        before = trimmed.trimmed_mean_launches
        mode = torch.cuda.get_sync_debug_mode()
        # torch.cuda.graph collects garbage as it enters; none may be
        # collected during the capture (freeing another graph's memory
        # there invalidates it)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    outs = self._body(eng)
                    self.out_vecs = self.packer.pack(outs)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except Exception as err:
            raise RuntimeError(
                "capture of a round that RoundEngine.graph_block_reason calls graph-safe "
                f"failed (attack {eng.attack!r}, aggregator {eng.aggregator!r}, fault "
                f"model {eng.fault_model!r}, async {eng.async_config!r}): {err}"
            ) from err
        finally:
            if collecting:
                gc.enable()
            captured = trimmed.trimmed_mean_launches - before
            trimmed.trimmed_mean_launches = before
        del outs
        eng.last_updates = eng.last_fault_diag = eng.last_async_diag = None
        eng.last_diagnostics = eng.last_audit_diag = eng.last_metric_pack = None
        self.graph, self.kernel_launches = graph, captured
        self.capture_seconds = time.perf_counter() - t0
        # the port's "compile": the timeline and the alert engine read these
        count_process("cuda.graph_captures")
        count_process("cuda.graph_capture_s", self.capture_seconds)

    def run(self, eng, state, specs, batches=None):
        """The rounds of ``specs`` of the engine ``eng`` (the one the graph
        was made for) from ``state``: ``(new state, outputs stacked [R])``;
        ``batches[i]`` is round i's ``(cx, cy)`` when the graph has no
        sampler."""
        write_back(self.state, state)
        rows = None
        for i, spec in enumerate(specs):
            self._set_inputs(spec, None if batches is None else batches[i])
            if self.graph is None:
                vecs = self._warm_up(eng)
                self._capture(eng)
            else:
                self.graph.replay()
                self.replays += 1
                trimmed.trimmed_mean_launches += self.kernel_launches
                vecs = self.out_vecs
            if rows is None:
                rows = self.packer.rows(len(specs), self.device)
            for dt, vec in vecs.items():
                rows[dt][i].copy_(vec)
        new_state = _clone_state(self.state)._replace(round_idx=specs[-1].round_idx + 1)
        return new_state, self.packer.unpack(rows)


def graph_key(engine, state, sampler=None, batch=None) -> tuple:
    """What one captured round is good for: the batch source (the sampler
    object, or the batch's shapes and dtypes), the state's layout and the
    fault model's program (``sweeps.static_fingerprint``: an engine-cache
    hit rebinds an equal one)."""
    from blades_tpu_torch.sweeps import program_fingerprint

    source: Any = (sampler if sampler is not None else
                   tuple((tuple(t.shape), t.dtype) for t in batch))
    return (source, state_signature(state),
            program_fingerprint(fault_model=engine.fault_model))


def run_graph(engine, state, specs, sampler=None, batches=None):
    """:meth:`RoundEngine._run_rounds` on the card: the engine's
    :class:`RoundGraph` run over ``specs``. The engine keeps one graph
    (``engine.last_graph``); when :func:`graph_key` changes, the old graph
    and its private pool are dropped before the new round is warmed up and
    captured."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA graph needs the card")
    batch = None if batches is None else batches[0]
    key = graph_key(engine, state, sampler, batch)
    graph = engine.last_graph
    if graph is None or graph.key != key:
        # the old graph and its pool go before the new one allocates
        engine.last_graph = graph = None
        engine.last_graph = graph = RoundGraph(engine, state, key, sampler=sampler, batch=batch)
    return graph.run(engine, state, specs, batches)
