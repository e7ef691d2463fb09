#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``blades_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-with OTHER.cu   # also time another build

It builds the port's CUDA kernel from ``blades_tpu_torch/csrc`` with
``nvcc``, holds the kernel against its plain PyTorch version on the card,
times both beside the card's bound and a one-call PyTorch yardstick, and
drives the port's paths through ``Simulator(...).run``, each with the
kernel's launch count set to 0 just before it and read just after: the
synchronous MLP round with ALIE and trimmed mean at K=1000 clients,
BASELINE config 1's shape, and the main path, CCT-2 (D = 283,723) on
CIFAR-shaped data at K=1000 in f32 and in bf16 (the kernel is also held
against its plain version on that round's own update matrix). Each path's
warm round is profiled, and one round of the MLP and one of CCT-2 run on
the card and on the CPU from the same inputs and are compared.

Then the attack and defense catalog on the same CCT-2 round at K=1000 in
bf16, 2 rounds each through ``Simulator.run``: every attack other than ALIE
with trimmed mean (b=5), so the kernel launches under each attack and its
count joins the path's; every dense aggregator other than mean and trimmed
mean under ALIE (f=5). Each record gives the warm round, the attack's or
aggregator's own time on that run's ``[1000, 283723]`` matrix, its host
syncs per call, its loop iterations and its peak memory. Every attack and
aggregator is then run on the card and on the CPU on the first 100 rows
and 16,384 columns of a round's matrix, with the same draws, and compared.

Then partial participation on the same bf16 CCT-2 round at K=1000 under
ALIE (f=5), with a fault model of 10% dropout, 5% stragglers (staleness
bound 1) and clients 10 and 11 corrupt: 3 rounds with NaN corruption and
trimmed mean (b=5), whose masked form replaces the kernel, each round's
fault counts checked against the received matrix, and 2 rounds with
bit-flip corruption (a ``[1000, 283723]`` draw); then 2 rounds with every
other registered aggregator in its masked form, each timed alone on the
round's received matrix and mask beside its dense form on the same matrix,
and the gossip aggregators on that matrix. Every masked form and the fault
model are then run on the card and on the CPU on ``[100, 16384]`` of a
round's matrix with the same mask and draws, and compared.

Then the streaming round (``run(streaming=True)``), whose update memory
is one ``[chunk, D]`` slab: the same bf16 CCT-2 round at K=1000 in 4 chunks
under sign flipping (f=5) with trimmed mean (b=5), streaming and dense, 3
rounds each, with a profiled warm round of each (the kernel launches in the
dense round only: the streaming chunks take the masked trimmed mean); the
mean's streaming round held to its dense round; 2 streaming rounds with
each streaming defense, its ``streaming_update`` timed on one chunk and its
``streaming_finalize`` alone, and the host syncs of a whole round counted;
a streaming round under dropout and NaN corruption whose fault counters
equal the dense round's; the streaming and the dense round at K=4000 in
chunks of 250, for peak memory; and each streaming defense's
``aggregate_streaming`` on ``[100, 16384]`` in 3 chunks on the card and on
the CPU.

Then composite attacks, persistent client state and the buffered-async
(FedBuff) round on the same bf16 CCT-2 round at K=1000 under trimmed mean
(b=5): 2 label flippers, 2 sign flippers and 1 ALIE client registered
together, each attacker's row held to what its own attack gives; Adam with
``persist=True`` beside ``persist=False``, its stacked moments changing and
finite; the zero-delay async round with ``buffer_m=1000``, whose params
equal the sync round's and which launches the kernel once a tick; the
general async round (uniform delays up to 2, ``buffer_m=250``, polynomial
staleness weights), its 10 counters a tick, host syncs, peak memory and the
masked trimmed mean's own time on the weighted buffer (no kernel launch);
the async pair (``asyncmean``, ``asynccenteredclipping``) under it and in
their streaming forms; geometric delays with a cutoff under 10% dropout;
and a K=16 MLP async run on the card against the CPU.

Then round blocks (``RoundEngine.run_block``, ``Simulator.run(block_size=
...)``), each against the same rounds run one by one, bit for bit, with
cuDNN's deterministic algorithms: the MLP at K=1000, 20 rounds one by one
and in blocks of 10 (one captured CUDA graph of the round, replayed), then
again with an ``EngineCache`` hit that captures nothing, and a warm block
against a warm round (wall, host syncs, busy share, the kernel's profiler
events against its counted launches); bf16 and f32 CCT-2 graph blocks
(round wall, capture time, peak memory); graph blocks under the fault
model and of async ticks (counters equal); a clipped-clustering graph
block, with the defense's own time eager and as a replayed graph of the
call; GeoMed and streaming blocks, which run eagerly and say why;
``ExperimentBatch`` of 2 at the MLP round, each column equal to its own
run; and the bf16 CCT-2 round's peak memory with the batch held by the
caller and donated to the engine (``run_round_donated``, as
``Simulator.run`` does every round).

Then real data from files and resumable runs, with cuDNN's deterministic
algorithms still on. The script writes CIFAR-10's python-pickle batches
(50,000 / 10,000 seeded uint8 images) and MNIST's gzipped IDX files
(60,000 / 10,000) into its temporary directory, and removes them at the
end. CIFAR-10 is split by Dirichlet(0.1) over K=1000 clients into a uint8
store on the card (load and partition seconds, N_max, the store's bytes
beside the float32 Synthetic store's). The bf16 CCT-2 round runs on it
through ``Simulator.run``, its sampler cropping, flipping, erasing and
normalizing inside the round: 3 rounds one by one, then as one captured
graph block held to them bit for bit (state and records); a warm block's
host syncs and its kernel events under the profiler against its counted
launches; the round with sampling beside the same round on the float32
Synthetic store; the sampler's device time on each store; the transform
and the normalizer alone on a round's ``[32000, 32, 32, 3]`` batch, and
on the card against the CPU on the same draws; the store placed on a
virtual ``(4, 1)`` mesh of the card (``FLDataset.place``), one round's
placed batches held bit for bit to the unplaced sampler's from the same
generator state, each sampler's device time beside the other, and the
store gathered whole again. Then the MLP at K=1000 on
the MNIST files (3 rounds) and the mini example
(``blades_tpu_torch/examples/mini_example.py``, K=10, ALIE f=4, mean, 2
rounds of 50 local steps). Then checkpoint and resume of the CIFAR-10
CCT-2 run under the fault model: an uninterrupted 4-round run against one
that checkpoints at round 2, crashes at round 3 (the crash autosave
fires) and is resumed by a fresh ``Simulator``, and against blocks of 2
resumed at a block boundary, all bit for bit, the straggler buffer
included; the save and the restore timed, with the file's size.

Then in-round forensics and the telemetry trace (slice 10a), with cuDNN's
deterministic algorithms on: the bf16 CCT-2 round at K=1000 through
``Simulator.run(collect_diagnostics=True, round_metrics=True,
audit_monitor=AuditMonitor(fallback_aggregator="trimmedmean"))``, 2 eager
rounds (the second captured by ``profile_dir``'s ``torch.profiler``, whose
records must say ok and whose trace file must exist) and the same 2 as a
captured graph block, the kernel launching twice
a round (the defense and the audit's fallback): the block's ``defense``,
``audit`` and ``metrics`` records equal the eager rounds' bit for bit, both
``telemetry.jsonl`` traces validate against the port's schema, the trim
counts sum to 2bD; a warm block's host syncs and its kernel events under
the profiler; the round's ``[1000, 283723]`` matrix copied to the CPU and
its trim counts (exactly), audit and metric pack computed there again; the
warm round with the three options on and off, the own time, host syncs and
extra peak memory of the trim-count diagnostics, the audit and the pack.
Then one streaming round with the metric pack and a median fallback,
against the dense round of the same rows.

Then the BASELINE models (slice 11a), BASELINE.md configs 2-5, on CIFAR-10
and CIFAR-100 files written at their published size (50,000 / 10,000
seeded images each, IID splits): ResNet-18 (D = 11,173,962) at K=100,
fedsgd, no attack, mean, a cold and 3 warm rounds in f32 and in bf16 and a
profiled warm round of each; then ALIE f=10 and trimmed mean b=10 in bf16,
the kernel once a round, held against its plain version on the round's own
``[100, 11173962]`` matrix and timed there beside the bound and the
library call, a profiled round's kernel events against its counted launch,
and 2 rounds as a captured graph block held to the same rounds one by one
bit for bit (cuDNN deterministic); IPM f=10 and Krum with 5 local steps;
ResNet-18 at K=1000 streaming in 10 chunks, sign flipping and the median;
WideResNet-28-10 at 100 classes (D = 36,536,884) at K=1000 streaming in 20
chunks, label flipping and clipped clustering; each with its round times,
peak memory and client chunks. Then one f32 round of ResNet-18 (K=4) and
of WideResNet-28-10 (K=2) at full width on the card and on the CPU, and
one client's float64 gradient on both.

The text models (slice 11b) run first, after the kernel's own checks, on
a card nothing else has used yet (their K=100 round peaks at 61 GB), on
SyntheticText stores with a 100,000-word vocabulary and rows of 8 to 64
tokens padded with 0 (10,000 / 2,000 rows over K=100, 32,000 over
K=1000): ``text_cct_2`` at its registry defaults (D = 30,352,643, the word
table 30,000,000 of it) at K=100 under ALIE f=10 and trimmed mean b=10, 3
rounds in f32 and in bf16, the kernel once a round on [100, 30352643]
(K*D = 3.04e9, past 2^31), held against its plain version on the f32
round's own matrix in column slices and timed there beside the bound, the
library call and an untied matrix of that shape; a profiled warm round of
each dtype; 2 bf16 rounds one by one and as one captured graph block (4
client chunks), bit for bit; the streaming round at K=1000 in 10 chunks of
100 (sign flipping f=100, the median; the dense matrix would be 121 GB);
each other family at full width (``text_cvt_2``, ``text_vit_2``,
``text_transformer_2``, ``text_cct_6``, ``long_text_transformer``):
logits and gradient on a padded batch on the card against the CPU; one
K=3 ``text_cct_2`` round on the card against the CPU (its CPU half a
process of its own); and the pretrained
path: a reference-named ``cct_7_3x1_32`` state dict written to a
temporary ``BLADES_TPU_WEIGHTS`` and loaded offline through
``create_model(..., pretrained=True)``, its logits on the card against
the CPU.

The run's own records (slice 10b), right after the forensics phases on the
same store: 3 bf16 CCT-2 rounds at K=1000 (ALIE f=5, trimmed mean b=5)
with the run ledger, alerts, the dispatch timeline and the heartbeat on
(``BLADES_LEDGER`` and ``BLADES_HEARTBEAT_FILE`` in the run's temporary
directory) and then off (``BLADES_TELEMETRY=0``): the ledger's started and
finished records, a ``timeline`` record a round, the heartbeat at the last
round, no alert, every record valid, the same host syncs on and off; a
graph block of 2 captured, then replayed with the records on and off (the
same host syncs) and held to an eager block record for record but times;
and an MLP at K=10 whose loss goes non-finite, with its critical alert
and alert file.

Then defense certification (slice 10b): one attack-search cell each at
K=100 and D = 283,723 (trimmed mean at f=10, the kernel once an
evaluation, and at f=20, the sort; the median and Krum at f=10), and the
kernel at [100, 283723], b=10, against its plain version and timed beside
its bound and the library call; then the certify script
(``blades_tpu_torch/examples/certify.py``) in its committed configuration
less the staleness columns (CERT_ARGS)
on the card through its ``main``, against a CPU run of the same (a
subprocess started before the text phases): verdicts exactly, ratios at CERT_TOL,
the kernel's launches equal to the plan's unmasked trimmed-mean
evaluations; timed in one run, its host syncs counted in a second, whose
every kernel launch is then held against the plain version on its own
input ([8, 32], b = 1-3) and each such shape timed. The run never appends to the checkout's ledger: every ledger
record goes to its temporary directory.

Last, ``ExperimentBatch(mode="vmap")`` (slice 7b) against map mode, S
experiments of one engine on one shared batch: the MLP at K=1000 (S=8),
BASELINE config 1's shape (K=10, 50 local steps, S=64) and bf16 CCT-2 at
K=1000 in 4 chunks (S=2), under ALIE and trimmed mean, each mode's warm
round timed, profiled and counted (one launch of the kernel's batched
entry a vmap round, S single launches a map round), the batched launch
held to S single launches (``torch.equal``) and to the plain version, and
timed at [8, 1000, 59850]; a fault-model and a GeoMed round at K=1000
(S=4); a batched launch past 2^31 elements; and remat (slice 2b): CCT-2
at K=1000 in 4 chunks in f32 and bf16 (and, among the text phases,
``text_cct_2`` at K=100 in f32), each with and without ``remat=True``:
cold and warm rounds, peak memory and the updates compared.

Then resilient sweeps and the run supervisor (slice 13a), after the vmap
phases: the certify phase's configuration again through its
``main`` with ``--attempts 2`` and a runner that fails one cell
(RESIL_POISON): that cell alone quarantined by bisection, every other
result bit for bit the ``certify`` phase's, the launches the plan's; a
group of 8 trimmed-mean search cells at K=100 and CCT-2's D under an
allocator capped between the peaks of half the group and the whole
(``torch.cuda.set_per_process_memory_fraction``): a real
``torch.cuda.OutOfMemoryError``, retried, bisected, every cell salvaged
bit for bit; a supervised child (``--sticky-child``) whose runner kills
its CUDA context with the kernel's raw entry on an address nothing owns:
``DeviceLost``, no quarantine journaled, and the relaunch under
``BLADES_RESUME=1`` finishes with none; CCT-2 at K=1000 (4 chunks, bf16,
ALIE f=5 + trimmed mean b=5, a checkpoint a round) through
``examples/supervised_run.py --child`` under the run supervisor, hung at
round 2 of 4: the heartbeat kill, no process left, the crash autosave
naming ``SupervisorTermination``, the relaunch ``torch.equal`` to an
uninterrupted child, the time to recover split and the card's free
memory before and after the kill; and ``examples/chaos.py --sweep 14``
on the card with zero violations, then a chaos child SIGKILLed at round 2
and resumed bit for bit. Every kernel launch of these paths is held
against the plain version (the children hold theirs).

Each phase prints one JSON line. The line before the last is the
``kernels`` record, and the last line is ``{"ok": true, "device": {...}}``,
printed only when every phase passed. Any failure raises and exits
non-zero; without CUDA it exits non-zero before doing anything.

``--compare-with`` names another source with the same C interface (an
earlier version of ``csrc/trimmed_mean.cu``); it is built beside the
kernel, at the same time, and timed in turns with it (other, this, this,
other) at every timed shape, in the ``kernel_compare`` records.
``--certify-only`` builds the kernel and runs only the certification
phases (about 3 minutes on the card), with no ``kernels`` or result line;
``--text-only`` likewise runs only the text and pretrained phases (about
2.7 minutes with the build), and ``--resilient-only`` a certify run on the
card and the slice 13a phases. ``--service-only`` runs only the
simulation service's phases (slice 13b.1), then the ``kernels`` line (the
service path alone) and the result line.

The service phases: ``service_simulate`` starts a server
(``examples/serve.py start``, a fresh interpreter) and submits the main
path's MLP at K=1000 (ALIE f=5 + trimmed mean b=5, 3 rounds) twice under
two ids, cold then warm, then the first id again (the spool answers):
the server's start to its socket and to the first cell's CUDA work, each
request's queue wait / build / execute split, the client's walls; the
two replies equal, the warm one with ``build_s`` 0; a drain exits 0.
``service_kernel`` runs the same request twice through
``SimulationService._execute`` in this process, 6 kernel launches each
held against the plain version, the cell bit for bit a direct
``Simulator`` run. ``service_certify`` submits the certify driver's
``--quick`` matrix with ``--via-service`` and holds it to an in-process
run on the card (verdicts exact, ratios CERT_TOL). ``service_chaos``
runs the service drills, the pool's ``worker_crash`` and ``worker_hang``
and the supervised SIGKILL resume, every pool shut down with no survivor.

The worker pool's phases (slice 13b.2), servers started by
``examples/serve.py start --workers N --device cuda`` whose workers find
POOL_SITE (a ``sitecustomize.py`` written into a temporary directory at
the head of their PYTHONPATH) and hold each kernel launch against the
plain version, writing the counts when they exit: ``pool_simulate``
(``--workers 2``) sends the request cold to worker A, then at once its
repeat (routed to A, warm, no build ``program`` record) and a second body
(B, cold); the workers' spawn to ``ready``, no torch mapped before the
first request, their memory idle and warm, the cold request's build
records against its worker's counters, and the share of its first round
that no program record of that round explains. ``pool_deadline``: two
servers (``--workers 1 --attempts 1``), ``--cell-deadline 2`` and a
deadline that lands in the middle of a cold worker's first round (from
``pool_simulate``'s cold request on the same machine); in each the parent
kills the cold worker in its first cell (the second inside CUDA work),
that request alone is quarantined and the replacement serves a probe; the
card's memory around each kill. ``pool_sticky``
(``--attempts 2``): the worker's first launch is preceded once by the
kernel's raw entry on an address nothing owns; the worker exits with
``DeviceLost`` and no reply, and the request completes on its replacement
with the held cell. Every served cell is bit for bit ``service_kernel``'s
and the direct run's. ``--pool-only`` runs ``service_kernel``, these
phases and the drills, then the ``kernels`` line and the result line.

Last, the reference CLI and the JAX examples' counterparts (slice 15a),
each through its own ``main`` in a working directory of its own, with the
card's numerics as the driver sets them (``utils/platform.py``) and put
back after, every kernel launch held against the plain version:
``drivers_cli_cifar10`` runs ``examples/cifar10.py`` on CIFAR-10 files of
the published layout with the reference recipe (CCT-2, K=20, ALIE f=8,
trimmed mean b=8, Adam persisting, 50 local steps of batch 32), 3 rounds
with validation each round: the cold and warm rounds, the local steps'
share of each (from the run's telemetry spans), the peak memory, one
launch a round, and the kernel timed at ``[20, 283723]``, b=8, tied and
untied; ``drivers_config1`` runs ``convergence_config1`` at its own
settings but DRIVERS_CONFIG1_ROUNDS rounds (3 runs of 5 of its 100
rounds of 50 local steps, the MLP at K=10), one launch a round in its
trimmed-mean run; ``drivers_examples`` runs the other
examples once, at their own settings but for ``customize_attack``
(DRIVERS_ATTACK_ROUNDS rounds) and the robustness matrix (its trimmed-mean
column, whose expectations are checked), with their own assertions
(FLTrust's margin among them). ``--drivers-only`` runs only these phases,
then the ``kernels`` line (these paths alone) and the result line.

The static linter and the round-program auditor (slice 14,
``blades_tpu_torch/analysis/``) run next to last, on a CIFAR-shaped store of their
own, each kernel launch held against the plain version, those inside a CUDA
graph after each replay on the buffers the replay left
(``_HeldGraphKernel``): ``analysis_tier_a`` runs ``python -m
blades_tpu_torch.analysis --check --tier a`` in a subprocess beside the
other two (its one JSON line, its seconds, and that it loaded no torch);
``analysis_tier_b`` runs ``run_tier_b(device="cuda")`` one program at a
time (the dense round, the block, the streaming round, ``ExperimentBatch``
in map and vmap modes, the async round; each check's result, the graph
captures and the launches per program); ``analysis_cct2`` takes the
auditor's storage, dtype and rebuild checks to the main path, bf16 CCT-2 at
K=1000 in 4 chunks under ALIE f=5 and trimmed mean b=5: one eager round
and one graph block of ANALYSIS_BLOCK_ROUNDS rounds, each run twice (the
second block adds no capture and no build). ``--analysis-only`` builds
the kernel and the CIFAR-shaped store and runs only these phases, then the
``kernels`` line and the result line.

After them, on the same store, the run-record readers, the last single-card
examples and the LEAF tools (slice 15b), every kernel launch held:
``tools_trace_cct2`` runs the telemetry example's recipe on the main path
(bf16 CCT-2 at K=1000 in 4 chunks, ALIE f=5 + trimmed mean b=5, 1 local
step, TOOLS_TRACE_ROUNDS rounds, ``collect_diagnostics=True``) and reads
its trace with the port's ``trace_summary --json``: ``format_table``'s
text, then one line with the round span's split (sample / dispatch /
sync / eval, the first round apart from the warm ones), the dispatch
share, the provenance, the byzantine share of the trimmed slots, the
peak memory and the launches; ``tools_examples`` runs ``telemetry_trace``,
``run_ledger``, ``defense_audit``, ``plot_comparing_aggregation_schemes``
and ``fedavg_ipm`` once each at their own settings (wall, launches, their
own assertions and claims), and the kernel is timed on each kernel path's
first input; ``tools_readers`` runs the certify driver's trimmed-mean
cells on the card, then the port's ``runs``, ``sweep_status`` and
``trace_summary`` over this run's ledger and traces, each a process of
its own that must exit 0 with one JSON line; ``tools_leaf`` runs the LEAF
preprocess pipeline and ``--verify`` on a FEMNIST-shaped directory it
writes (10,000 samples of 784 floats over 100 users), on the host only, in
a process of its own beside the others. ``--tools-only`` builds the kernel
and the store and runs only these phases, then the ``kernels`` line and the
result line.

Last, the parallel layer (slice 12, ``blades_tpu_torch/parallel/``), on
virtual meshes of the one card (every entry ``cuda:0``, so each ``.to()``
is a no-op and a sharded run costs the partitioning alone, not transfers):
``parallel_mesh_cct2`` runs the main path (bf16 CCT-2 at K=1000 in 4
chunks, ALIE f=5 + trimmed mean b=5, 1 local step of batch 32)
PARALLEL_ROUNDS rounds unsharded and then through
``Simulator(mesh_shape=(2, 2), mesh_devices=[cuda:0] * 4)`` from the same
seed, the unsharded run on the store whole, the mesh run on the store the
Simulator places (``FLDataset.place``: each mesh row's 500 clients a view
on its row's entry, the batches sampled by rows), and compares their
params and each round's aggregate (bar ``ROUND_TOL``, and bit for bit),
each row's store rows printed, the kernel twice a round on the
model axis's column blocks ``[1000, 141862]`` and ``[1000, 141861]``, each
launch held, the warm rounds and the peak memory side by side;
``parallel_seq_text`` builds the long-context example's model
(``long_text_transformer(num_classes=4, num_heads=8,
word_embedding_dim=128)``, depth 2) at PARALLEL_SEQ tokens, batch
PARALLEL_SEQ_BATCH, on a ``seq`` mesh of 8 entries, and holds ring and
Ulysses attention to the dense model (logits within 3e-4, one backward's
gradient per leaf within PARALLEL_GRAD_REL_L2), with each model's warm
forward and peak memory; ``parallel_dist_nccl`` runs the multi-process
worker as a one-rank NCCL job (``run_local_cluster(1, 8, backend="nccl")``:
the MLP round under IPM + trimmed mean, the kernel held in the worker),
whose ``DIST_RESULT`` must equal the same round in this process, then the
ported ``multihost_pod`` example as a one-rank job of the launcher's
environment with ``POD_ROUNDS=2`` and ``POD_CLIENTS=256``; the two NCCL
children run side by side in threads beside ``parallel_seq_text``. NCCL
refuses two ranks on one device, so the two-rank form waits for a second
card. In the whole script the end builds one CIFAR-shaped store, runs
``tools_trace_cct2`` on it with nothing beside it, then starts the two
children beside the analysis phases, ``tools_examples`` and
``tools_readers``, and waits for them before the kernel's timings and the
timed parallel phases. ``--parallel-only`` builds the kernel and the
CIFAR-shaped store and runs only these phases, then the ``kernels`` line
and the result line.

References that time nothing run in processes of their own beside the
main thread: the certify phase's CPU reference and the text card-vs-CPU
round's CPU half start beside the kernel's build, ``supervised_cct2``'s
uninterrupted child beside ``resnet_card_vs_cpu``.

Every JSON line carries ``elapsed_s``, the seconds since the script
started, and ``since_last_s``, the seconds since the line before.

Imports nothing of JAX or of the JAX package ``blades_tpu``.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# [K, D, b]: BASELINE config 1 (K=10, b=5 auto-shrunk to 4), the main path's
# K=1000 with b=5 and with the largest kernel b=16, CCT-2's D
# (docs/performance.md:890), a K the kernel streams in chunks, and a ragged D
KERNEL_SHAPES = [(10, 59_850, 4), (1000, 59_850, 5), (1000, 59_850, 16), (1000, 283_723, 5),
                 (8192, 59_850, 5), (33, 257, 3)]
TIMED_SHAPES = KERNEL_SHAPES[:5]
MAIN_CLIENTS, MAIN_BYZANTINE = 1000, 5  # the main path's population and b
TOL = dict(rtol=1e-5, atol=1e-5)  # f32: only the summation order differs
# card vs CPU round: the same f32 math, with matmuls and reductions summed in
# other orders (TF32 off on both backends)
ROUND_TOL = dict(rtol=1e-4, atol=1e-5)
MAX_KINK_ROWS = 5  # of the main path's 1000 client rows (see phase_card_vs_cpu)
# CCT-2 (D = 283,723) on CIFAR-shaped data: the population, the rounds in
# f32 and in bf16, the client chunks that bound activation memory
CCT2_SHAPE = (1000, 283_723, 5)
CCT2_ROUNDS_F32, CCT2_ROUNDS_BF16, CCT2_CHUNKS = 3, 2, 4
# card vs CPU at CCT-2's full width: K=16, f=2, b=2, and at most this many
# update rows outside ROUND_TOL (a ReLU pre-activation within rounding of 0,
# or a max-pool window whose two largest entries are equal in exact
# arithmetic, takes the other branch on the other backend)
CCT2_CPU_CLIENTS, CCT2_CPU_BYZANTINE, CCT2_MAX_KINK_ROWS = 16, 2, 2
# the attack and defense catalog on the CCT-2 round, in bf16: the attacks run
# with trimmed mean (b=5), the aggregators under ALIE (f=5)
CATALOG_ATTACKS = ("ipm", "signflipping", "labelflipping", "noise", "minmax", "minsum")
CATALOG_AGGREGATORS = ("median", "krum", "multikrum", "geomed", "autogm", "centeredclipping",
                       "clustering", "clippedclustering", "fltrust", "dnc")
CATALOG_ROUNDS = 2
# card vs CPU: the first rows and columns of a CCT-2 round's update matrix;
# f32 TOL, and for GeoMed and AutoGM (loops that compound rounding) LOOP_TOL,
# as in the CPU tests
CATALOG_CPU_SHAPE = (100, 16_384)
LOOP_TOL = dict(rtol=1e-4, atol=1e-6)
# partial participation on the CCT-2 round, in bf16 under ALIE (f=5): the
# fault model, its rounds with NaN and with bit-flip corruption (trimmed
# mean b=5), and the rounds of each other registered aggregator
FAULTS = dict(dropout_rate=0.1, straggler_rate=0.05, max_staleness=1, corrupt_clients=(10, 11))
FAULT_ROUNDS, FAULT_BITFLIP_ROUNDS, FAULT_AGG_ROUNDS = 3, 2, 2
FAULT_AGGREGATORS = ("mean", "median", "krum", "multikrum", "geomed", "autogm",
                     "centeredclipping", "clustering", "clippedclustering", "fltrust",
                     "byzantinesgd", "dnc", "signguard")
# the streaming round on CCT-2 in bf16 under sign flipping (f=5, row-local):
# its rounds, the streaming defenses, the fault model of stream_fault, and
# the scale point (K=4000 in chunks of 250, the K=1000 round's chunk size)
STREAM_ROUNDS, STREAM_AGG_ROUNDS = 3, 2
STREAM_AGGREGATORS = ("mean", "trimmedmean", "median", "krum", "multikrum", "geomed",
                      "autogm", "centeredclipping", "clustering", "clippedclustering",
                      "signguard")
STREAM_FAULTS = dict(dropout_rate=0.1, corrupt_rate=0.02, corrupt_mode="nan")
STREAM_SCALE_CLIENTS, STREAM_SCALE_CHUNKS, STREAM_SCALE_ROUNDS = 4000, 16, 2
# composite attacks, persistent client state and the buffered-async round on
# the bf16 CCT-2 round at K=1000 (4 chunks) under trimmed mean b=5: the
# registered attackers (2 label flippers, 2 sign flippers, 1 ALIE client),
# the rounds or ticks of each phase, the async configurations
COMPOSITE_ROUNDS, PERSIST_ROUNDS, PERSIST_CLIENT_LR = 2, 3, 1e-3
ASYNC_STATIC_ROUNDS, ASYNC_TICKS, ASYNC_AGG_TICKS, ASYNC_STREAM_ROUNDS = 2, 4, 2, 2
# a delay-3 client drawn at tick 0 arrives at tick 4, 3 ticks stale: past
# the cutoff of 2
ASYNC_FAULT_TICKS = 5
ASYNC_CONFIG = dict(buffer_m=250, arrivals=dict(kind="uniform", max_delay=2),
                    staleness="polynomial")
ASYNC_FAULT_CONFIG = dict(buffer_m=250, arrivals=dict(kind="geometric", mean_delay=1.0,
                                                      max_delay=3), staleness="cutoff", cutoff=2)
ASYNC_FAULTS = dict(dropout_rate=0.1)
ASYNC_AGGREGATORS = ("asyncmean", "asynccenteredclipping")
# card vs CPU: a K=16 MLP async run with fixed delays, 3 ticks
ASYNC_CPU_CLIENTS, ASYNC_CPU_TICKS = 16, 3
# bf16 rows compared across runs: relative L2 error (the CCT tests' bar)
BF16_ROW_REL = 2e-2
# round blocks (RoundEngine.run_block; a replayed CUDA graph where the
# configuration is graph-safe): the MLP's rounds and block size, the bf16
# and f32 CCT-2 blocks, the fault-model and async blocks, the linkage
# block, the eager blocks (GeoMed, streaming), the experiments of
# ExperimentBatch and the rounds of the donated-batch runs
BLOCK_MLP_ROUNDS, BLOCK_MLP_SIZE = 20, 10
BLOCK_CCT2_ROUNDS, BLOCK_F32_ROUNDS, BLOCK_SLICE_ROUNDS = 3, 2, 3
BLOCK_LINKAGE_ROUNDS, BLOCK_EAGER_ROUNDS, EXPERIMENTS, DONATE_ROUNDS = 2, 2, 2, 2
# real data from files (slice 4) and resume (slice 5): CIFAR-10 and MNIST at
# their published sizes (written by the script from a seed), CIFAR-10's
# Dirichlet split (alpha 0.1, the reference's non-IID setting); the rounds
# of the CIFAR-10 runs and of the MNIST MLP; the mini example's rounds and
# local steps; a round's images at K=1000 (1 step of 32); the checkpoint
# phase's rounds, checkpoint interval, crash round and block size
CIFAR10_TRAIN, CIFAR10_TEST, MNIST_TRAIN, MNIST_TEST = 50_000, 10_000, 60_000, 10_000
DATA_ALPHA, DATA_EAGER_ROUNDS, DATA_BLOCK_ROUNDS, DATA_MLP_ROUNDS = 0.1, 3, 3, 3
MINI_ROUNDS, MINI_STEPS, AUGMENT_BATCH, SAMPLER_CALLS = 2, 50, 32_000, 5
# profiled warm blocks: the most times one is run under torch.profiler
# until the kernel's device events equal its counted launches (the
# profiler loses some device events; profiled_block)
PROFILE_ATTEMPTS = 3
CKPT_ROUNDS, CKPT_AT, CKPT_CRASH_AT, CKPT_BLOCK = 4, 2, 3, 2
# in-round forensics and the telemetry trace (slice 10a): the eager rounds
# and the graph block of the forensics phase
FORENSICS_ROUNDS = 2
# the BASELINE models (slice 11a), BASELINE.md configs 2-5, on CIFAR-10 and
# CIFAR-100 files written at their published size: ResNet-18 (D =
# 11,173,962) at K=100, cold and warm rounds in f32 and bf16 (config 2);
# the kernel's shape there, ALIE f=10 and trimmed mean b=10, its eager
# rounds and graph block; IPM + Krum with 5 local steps (config 3); the
# streaming rounds at K=1000 of ResNet-18 (config 4) and of WideResNet-28-10
# at 100 classes (D = 36,536,884, config 5); client chunks as the card's
# memory needs them (one chunk of 100 peaked at 38.8 GB in f32 and 23.5 GB
# in bf16, a WRN chunk of 50 at 46.2 GB, on an H100 80GB); card against CPU
# at K=2 and K=1
RESNET18_DIM, WRN_DIM = 11_173_962, 36_536_884
RESNET_CLIENTS, RESNET_WARM_ROUNDS = 100, 3
RESNET_CHUNKS = {"float32": 1, "bfloat16": 1}
RESNET18_SHAPE = (RESNET_CLIENTS, RESNET18_DIM, 10)
RESNET_BYZANTINE = RESNET18_SHAPE[2]
RESNET_KERNEL_ROUNDS, RESNET_BLOCK_ROUNDS, KRUM_ROUNDS, KRUM_STEPS = 2, 2, 2, 5
RESNET_STREAM_CLIENTS, RESNET_STREAM_CHUNKS, RESNET_STREAM_ROUNDS = 1000, 10, 2
WRN_CLIENTS, WRN_CHUNKS, WRN_ROUNDS = 1000, 20, 2
# card vs CPU: (model, classes, K) at batch 32. Each backend's float32
# gradient of these nets is itself about 1e-4 to 5e-4 (relative L2) from
# the float64 one on the same backend (a ReLU input within rounding of 0
# takes either side), while the two backends' float64 gradients agree to
# about 3e-8 (the loss is taken in float32); so f32 rows are held at 2e-3
# and one client's float64 gradient (its first RESNET_F64_BATCH samples) at
# 1e-6. The phase records each backend's f32-to-f64 distance beside them
RESNET_CPU = (("resnet18", 10, 2), ("wrn_28_10", 100, 1))
RESNET_ROW_REL, RESNET_F64_REL, RESNET_F64_BATCH = 2e-3, 1e-6, 16
# the run's records (slice 10b): the bf16 CCT-2 rounds with the ledger,
# alerts, timeline and heartbeat on and then off, a graph block of 2, and
# the MLP at K=10 whose client learning rate overflows the weights
RECORDS_ROUNDS, RECORDS_BLOCK, NAN_CLIENTS, NAN_CLIENT_LR = 3, 2, 10, 1e20
# defense certification (slice 10b): the certify script's committed
# configuration (its defaults: the whole pool, the default grids, K=8,
# D=32, 3 trials, seed 0), synchronous cells only, on the card against a
# CPU run of the same (a subprocess on CERT_CPU_THREADS threads, running
# beside the card phases); the search ratios at CERT_TOL. Then one search
# cell each at K=100 (BASELINE config 2's population) and CCT-2's D
CERT_TOL = dict(rtol=1e-4, atol=1e-6)
CERT_CPU_THREADS = 4
#: the committed configuration's synchronous cells (its 64 cells and 16
#: batteries of 208 specs): the staleness columns doubled the certify
#: phase (66-93 s on the card) and the whole script passed 1050 s; they
#: stay on the card in service_certify's --quick request against its
#: in-process run
CERT_ARGS = ("--no-async",)
#: the defenses of the certify phase's counted run: the kernel's, so it
#: keeps every launch of the timed run at a sixteenth of its cells
CERT_COUNTED_AGGS = ("trimmedmean",)
CERT_SCALE_CLIENTS, CERT_SCALE_TRIALS = 100, 3
CERT_SCALE_CELLS = (("trimmedmean", 10), ("trimmedmean", 20), ("median", 10), ("krum", 10))
CERT_SCALE_B = 10  # the kernel's b at that shape (trimmed mean at f=10)
# the text models (slice 11b): SyntheticText with a 100,000-word vocabulary
# (every row of text_cct_2's word table can be drawn) and rows of 8 to 64
# tokens; TEXT_TRAIN / TEXT_TEST rows at K=100 and TEXT_STREAM_TRAIN (32 a
# client) at K=1000. text_cct_2 at its registry defaults (D = 30,352,643)
# at K=100 under ALIE f=10 and trimmed mean b=10: K*D = 3.04e9, past 2^31;
# the rounds and client chunks by dtype, the column slices of the plain
# version's check, the graph block's rounds; the streaming round at K=1000
# (sign flipping f=100, the median); the other families' card-vs-CPU batch
# and its gradient bar (a ReLU input or max-pool window within rounding
# takes the other branch on the other backend, as RESNET_ROW_REL says);
# the card-vs-CPU round
TEXT_VOCAB, TEXT_SEQ, TEXT_MIN_LEN = 100_000, 64, 8
TEXT_TRAIN, TEXT_TEST, TEXT_STREAM_TRAIN = 10_000, 2_000, 32_000
TEXT_SHAPE = (100, 30_352_643, 10)
TEXT_ROUNDS, TEXT_KERNEL_SLICES, TEXT_BLOCK_ROUNDS = 3, 8, 2
TEXT_CHUNKS = {"float32": 1, "bfloat16": 1}
# the graph block's chunks: a captured round keeps its peak in the graph's
# private pool beside the eager rounds' memory, and one chunk of 100 (48.9
# GB eager in bf16) ran out of the card's 80 GB while capturing
TEXT_BLOCK_CHUNKS = 4
TEXT_STREAM_CLIENTS, TEXT_STREAM_CHUNKS, TEXT_STREAM_ROUNDS = 1000, 10, 2
TEXT_STREAM_BYZANTINE = 100
TEXT_FAMILIES = ("text_cvt_2", "text_vit_2", "text_transformer_2", "text_cct_6",
                 "long_text_transformer")
TEXT_FAMILY_BATCH, TEXT_GRAD_REL = 32, 2e-3
# the card-vs-CPU text round: 3 clients, f=1, b=1 (K=6, f=2 took 79-83 s
# of the host's CPU)
TEXT_CPU_CLIENTS, TEXT_CPU_BYZANTINE, TEXT_MAX_KINK_ROWS = 3, 1, 1
#: torch threads of text_card_vs_cpu's CPU half, a process of its own that
#: the whole script starts beside the build (on the main thread its round
#: took 40-53 s of the script)
TEXT_CPU_THREADS = 4
# ExperimentBatch(mode="vmap") (slice 7b) against map mode: the experiments
# of the MLP at K=1000, of BASELINE config 1's shape (K=10, 50 local steps),
# of bf16 CCT-2 at K=1000 and of the looping cells (a fault model, GeoMed);
# the warm rounds timed in each mode (one since the whole script reached
# 1050 s with the slice 15a phases: config 1's S=64 map round is the
# largest of them); remat (slice 2b): the warm rounds
VMAP_MLP_S, VMAP_CONFIG1_S, VMAP_CONFIG1_STEPS, VMAP_CCT2_S, VMAP_LOOP_S = 8, 64, 50, 2, 4
VMAP_WARM, REMAT_WARM = 1, 2
VMAP_BIG_SHAPE = (2, 100, 10_800_000, 10)  # [S, K, D, b]: S*K*D past 2^31 (8.64 GB)
# resilient sweeps and supervision (slice 13a): the poison cell of the
# certify driver's committed configuration; the OOM group (OOM_CELLS
# trimmed-mean cells, b = OOM_B, at K=100 and CCT-2's D, OOM_TRIALS trials
# each on the host, staged onto the card by the group's runner, the quick
# grids); the cell whose group kills the CUDA context in the sticky child
# and that child's sweep; the supervised CCT-2 run (K=1000, 4 chunks,
# bf16, ALIE f=5 + trimmed mean b=5, a checkpoint a round) hung once at
# SUP_HANG_AT of SUP_ROUNDS, its heartbeat timeout above a warm round with
# its checkpoint and the child's kernel check (under 1 s on the card, PR
# 15; a 1.14 GB checkpoint, which holds a straggler buffer, saves in
# 1.35-1.97 s, PR 9), its SIGTERM grace above the crash autosave; the
# chaos sweep (one seed for each defense of the pool) and its supervised
# SIGKILL child
#: (a trimmed-mean cell that shares its group, here with the trimmed
#: mean's battery: under CERT_ARGS a cell of its own, as trimmedmean/f2 is,
#: is quarantined with no bisection)
RESIL_POISON = "trimmedmean/f3"
#: the defenses of resilient_certify's matrix (``--aggs``): the poisoned
#: cell's and two headline ones, a fifth of the committed configuration's
#: cells, to keep the script within its time limit
RESIL_AGGS = ("median", "trimmedmean", "krum")
OOM_CELLS, OOM_TRIALS, OOM_B = 8, 2, 10
STICKY_CELL = "trimmedmean/f2"
STICKY_ARGS = ("--quick", "--no-async", "--aggs", "mean", "trimmedmean")
SUP_ROUNDS, SUP_HANG_AT, SUP_HEARTBEAT_S, SUP_TERM_GRACE_S = 4, 2, 5.0, 60.0
CHAOS_SCENARIOS, CHAOS_KILL_SEED, CHAOS_KILL_AT = 14, 1, 2
# the children that run beside the host-bound certify run keep to 2 threads
BESIDE_ENV = {"OMP_NUM_THREADS": "2"}
# the simulation service (slice 13b.1): the main path's MLP configuration as
# one simulate cell (the service's Synthetic is MNIST-shaped: D = 59,850),
# K=1000, ALIE f=5 + trimmed mean b=5, 3 rounds of batch 32; the certify
# driver's quick matrix as a sweep request
SERVICE_CELL = {"label": "main", "model": "mlp", "clients": MAIN_CLIENTS, "train_size": 50_000,
                "attack": "alie", "num_byz": MAIN_BYZANTINE, "agg": "trimmedmean",
                "agg_kws": {"num_byzantine": MAIN_BYZANTINE}, "rounds": 3,
                "train_batch_size": 32, "seed": 1}
SERVICE_REQUEST = {"kind": "simulate", "cells": [SERVICE_CELL]}
SERVICE_CERT_ARGS = ("--quick",)
SERVICE_SHAPE = (MAIN_CLIENTS, 59_850, MAIN_BYZANTINE)


#: the script's start, for the elapsed stamp on every line
T0 = time.perf_counter()
_LAST_EMIT = [T0]


def emit(record: dict) -> None:
    """One JSON line, stamped with the seconds since the script started
    (``elapsed_s``) and since the line before (``since_last_s``)."""
    now = time.perf_counter()
    record = {**record, "elapsed_s": round(now - T0, 3),
              "since_last_s": round(now - _LAST_EMIT[0], 3)}
    _LAST_EMIT[0] = now
    print(json.dumps(record), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def deterministic_cudnn():
    """cuDNN's deterministic algorithms for a ``with`` block, put back as
    they were after it (``utils/platform.py:numerics_scope``)."""
    from blades_tpu_torch.utils.platform import numerics_scope

    return numerics_scope(cudnn_deterministic=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(k: int, d: int) -> tuple:
    """Least time for the function on this card: read [K, D] f32 once, write
    [D] f32 once; at least one compare-or-add per input element, at the f32
    rate. The larger of the two, and which one it is."""
    bytes_ms = (k * d * 4 + d * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * k * d / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def kernel_timings(torch, trimmed, x, b: int, reps: int = 5) -> dict:
    """The kernel, its plain version and ``torch.sort`` + slice + mean on
    ``x`` (CUDA events; the kernel over 20 calls, the others over ``reps``),
    beside the card's bound for ``x``'s shape."""
    k, d = x.shape
    bnd, by = bound_ms(k, d)
    return dict(ms=time_ms(lambda: trimmed.trimmed_mean_cuda(x, b), reps=20),
                plain_ms=time_ms(lambda: trimmed.trimmed_mean_plain(x, b), reps=reps, warmup=1),
                library_ms=time_ms(lambda: torch.sort(x, 0)[0][b:k - b].mean(0), reps=reps,
                                   warmup=1),
                bound_ms=bnd, bound_by=by)


def profiled_kernel_ms(torch, fn, reps: int = 20):
    """Device time of one launch of the trimmed-mean kernel from
    ``torch.profiler`` (no host wrapper cost in it), or None when the
    profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and "trimmed_mean_kernel" in e.key]
    return sum(us) / 1e3 / reps if us else None


def kernel_cases(torch, dev):
    """(name, [K, D] matrix on the card, b) for every kernel check."""
    g = torch.Generator(device="cpu").manual_seed(0)
    cases = []
    for k, d, b in KERNEL_SHAPES:
        x = torch.randn(k, d, generator=g) * 1e-2
        x[: b + 1] = x[0]  # ALIE-style identical rows: ties across both trims
        cases.append((f"K{k}-D{d}-b{b}", x, b))
    ties = torch.tensor([[5.0, 1.0], [5.0, 1.0], [0.0, 1.0], [-5.0, 0.0],
                         [-5.0, 0.0], [2.0, 0.5]])
    cases.append(("ties-6x2-b2", ties, 2))
    equal = torch.randn(12, 5, generator=g)
    equal[:, 2] = 0.75
    cases.append(("all-equal-column-b3", equal, 3))
    extremes = torch.randn(10, 65, generator=g)
    extremes[0], extremes[1], extremes[2] = 1e30, -3e38, 3e38
    cases.append(("extremes-b3", extremes, 3))
    # columns that overflow the kernel's candidate list and take its general
    # route: equal values, mixed -0.0 and 0.0, every lane's rows above the
    # next lane's
    general = torch.randn(1000, 48, generator=g)
    general[:, 0] = 0.75
    general[:, 1] = 0.0
    general[::3, 1] = -0.0
    rows = torch.arange(1000, dtype=torch.float32)
    general[:, 2:] = ((rows % 32) * 100 + rows // 32)[:, None] + torch.rand(1, 46, generator=g)
    for b in (1, 5, 16):
        cases.append((f"general-route-K1000-b{b}", general, b))
    return [(name, x.to(dev).contiguous(), b) for name, x, b in cases]


def phase_kernel(torch, trimmed, dev, card: str, other=None) -> dict:
    """Every case against the plain version; the timed shapes beside the
    bound, the plain version, the library yardstick and, with ``other``
    (a launch function of another build), that build in turns."""
    max_err = 0.0
    timings = {}
    for name, x, b in kernel_cases(torch, dev):
        got = trimmed.trimmed_mean_cuda(x, b)
        ref = trimmed.trimmed_mean_plain(x, b)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, **TOL))
        rec = {"phase": "kernel_check", "case": name, "max_abs_err": err, "ok": ok}
        k, d = x.shape
        if (k, d, b) in TIMED_SHAPES:
            kern = time_ms(lambda: trimmed.trimmed_mean_cuda(x, b), reps=20)
            plain = time_ms(lambda: trimmed.trimmed_mean_plain(x, b), reps=5, warmup=1)
            lib = time_ms(lambda: torch.sort(x, 0)[0][b : k - b].mean(0), reps=5, warmup=1)
            bnd, by = bound_ms(k, d)
            timings[(k, d, b)] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                                      bound_ms=bnd, bound_by=by)
            rec.update(timings[(k, d, b)], share_of_bound=bnd / kern,
                       profiler_ms=profiled_kernel_ms(torch, lambda: trimmed.trimmed_mean_cuda(x, b)),
                       tile_rows=trimmed.kernel_tile_rows(k), card=card)
            if other is not None:
                mine = lambda: trimmed.trimmed_mean_cuda(x, b)  # noqa: E731
                theirs = lambda: other(x, b)  # noqa: E731
                turns = [time_ms(f, reps=20) for f in (theirs, mine, mine, theirs)]
                emit({"phase": "kernel_compare", "case": name, "other_ms": [turns[0], turns[3]],
                      "ms": [turns[1], turns[2]], "other_max_abs_err": float(
                          (other(x, b) - ref).abs().max()), "bound_ms": bnd, "card": card})
        emit(rec)
        check(ok, f"{name}: kernel and plain version differ by {err} (tol {TOL})")
        max_err = max(max_err, err)
    return max_err, timings


def phase_main_path(torch, trimmed, dev, card: str, log_root: Path):
    """The MLP at K=1000, ALIE + trimmed mean (b=5), 3 rounds through
    Simulator.run; returns the kernel's launches during the run and the
    simulator."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    k, f = MAIN_CLIENTS, MAIN_BYZANTINE
    sim = Simulator(
        dataset=Synthetic(num_clients=k, train_bs=32, train_size=50_000, cache=False),
        attack="alie", num_byzantine=f, aggregator="trimmedmean",
        aggregator_kws={"num_byzantine": f}, seed=1, device=dev,
        log_path=str(log_root / "main_path"),
    )
    seen = []

    def on_round_end(rnd, state, m):
        u = sim.engine.last_updates
        seen.append((tuple(u.shape), u.device.type, u.dtype, float(m.train_loss)))

    torch.cuda.reset_peak_memory_stats()
    trimmed.trimmed_mean_launches = 0
    times = sim.run(model="mlp", global_rounds=3, local_steps=1, server_lr=1.0,
                    client_lr=0.1, validate_interval=3, on_round_end=on_round_end)
    torch.cuda.synchronize()
    launches = trimmed.trimmed_mean_launches
    peak = torch.cuda.max_memory_allocated()

    losses = [s[3] for s in seen]
    emit({"phase": "main_path", "clients": k, "byzantine": f, "b": f, "rounds": 3,
          "kernel_launches": launches, "updates_shape": list(seen[0][0]),
          "updates_device": seen[0][1], "train_loss": losses, "round_s": times,
          "rounds_per_s_after_first": 2 / sum(times[1:]),
          "peak_mem_bytes": peak, "card": card})
    check(launches == 3, f"kernel launched {launches} times in 3 rounds, want 3")
    check(all(s[:3] == ((k, 59_850), "cuda", torch.float32) for s in seen),
          f"update matrices {[s[:3] for s in seen]}")
    check(all(torch.isfinite(torch.tensor(losses))), f"non-finite losses {losses}")
    return launches, sim


def phase_profile(torch, trimmed, sim, card: str, other=None) -> None:
    """Where one warm main-path round's time goes on the card:
    ``torch.profiler`` device time by kernel beside the round's host wall
    time (synchronised). Device time 0 means the profiler saw no device
    activity here (not measured). Then the wall time of 20 warm rounds; with
    ``other`` (another build's launch function), 10 through each build in
    turns of 5 (this, other, other, this)."""
    from torch.profiler import ProfilerActivity, profile

    from blades_tpu_torch.utils import rng

    eng, state = sim.engine, sim.server.state
    cx, cy = sim.dataset.sample_round(rng.generator(sim.seed, 99, rng.DATA, device=eng.device),
                                      1, 32)
    eng.run_round(state, cx, cy, 0.1, 1.0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_round(state, cx, cy, 0.1, 1.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernel events only: an aten op's own row repeats the device
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in events
                    if "trimmed_mean_kernel" in e.key) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    emit({"phase": "profile_round", "clients": eng.num_clients, "wall_ms": wall_ms,
          "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
          "trimmed_mean_kernel_ms": kernel_ms,
          "top_kernels_ms": [[e.key[:90], e.self_device_time_total / 1e3, e.count]
                             for e in top],
          "card": card})

    def rounds(n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            eng.run_round(state, cx, cy, 0.1, 1.0)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    mine, theirs = [], []
    mine_cuda = trimmed.trimmed_mean_cuda
    for turn in ("mine", "other", "other", "mine") if other else ("mine",) * 4:
        trimmed.trimmed_mean_cuda = other if turn == "other" else mine_cuda
        try:
            (theirs if turn == "other" else mine).extend(rounds(5))
        finally:
            trimmed.trimmed_mean_cuda = mine_cuda
    # the build-provenance scope's cost with telemetry off: the engine's
    # scope against none around the same warm round, in turns (on, off, off,
    # on) of 25 rounds
    from contextlib import nullcontext

    from blades_tpu_torch.telemetry import set_recorder

    scoped, bare = [], []
    prev = set_recorder(None)
    try:
        for turn in ("on", "off", "off", "on"):
            if turn == "off":
                eng._provenance = lambda *a, **k: nullcontext()
            try:
                (bare if turn == "off" else scoped).extend(rounds(25))
            finally:
                eng.__dict__.pop("_provenance", None)
    finally:
        set_recorder(prev)
    rec = {"phase": "warm_rounds", "clients": eng.num_clients, "round_ms": mine,
           "median_ms": sorted(mine)[len(mine) // 2],
           "provenance_on_median_ms": sorted(scoped)[len(scoped) // 2],
           "provenance_off_median_ms": sorted(bare)[len(bare) // 2], "card": card}
    if other:
        rec.update(other_round_ms=theirs, other_median_ms=sorted(theirs)[len(theirs) // 2])
    emit(rec)


def phase_card_vs_cpu(torch, dev) -> None:
    """One main-path round on the card and on the CPU from the same params
    and the same batches: the aggregate and the new params within
    ROUND_TOL, and every client's update row within ROUND_TOL but for at
    most MAX_KINK_ROWS rows. A ReLU pre-activation within rounding of zero
    can take the other side of the kink on the other backend and change that
    one sample's gradient outright; such a row is reported, not hidden, and
    the trimmed mean bounds what it does to the aggregate."""
    from blades_tpu_torch.aggregators import Trimmedmean
    from blades_tpu_torch.attackers import Alie
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.models import create_mnist_model
    from blades_tpu_torch.ops.pytree import ravel

    k, f = MAIN_CLIENTS, MAIN_BYZANTINE
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(11))
    ds = Synthetic(num_clients=k, train_bs=32, train_size=50_000, cache=False).get_dls("cpu")
    cx, cy = ds.sample_round(torch.Generator().manual_seed(12), 1, 32)
    out = {}
    for where in ("cpu", dev):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=k, num_byzantine=f,
                          attack=Alie(num_clients=k, num_byzantine=f),
                          aggregator=Trimmedmean(num_byzantine=f), device=where)
        state, _ = eng.run_round(eng.init(params), cx.to(where), cy.to(where), 0.1, 1.0)
        agg, _ = eng.aggregator.aggregate(eng.last_updates)  # what the round applied
        out[str(where)] = (eng.last_updates.cpu(), agg.cpu(),
                           ravel(state.params, spec.layout).cpu())
    (u_cpu, a_cpu, p_cpu), (u_gpu, a_gpu, p_gpu) = out["cpu"], out[str(dev)]
    row_ok = torch.isclose(u_gpu, u_cpu, **ROUND_TOL).all(dim=1)
    emit({"phase": "card_vs_cpu_round", "clients": k, "tol": ROUND_TOL,
          "updates_max_abs_err": float((u_gpu - u_cpu).abs().max()),
          "update_rows_outside_tol": torch.nonzero(~row_ok).flatten().tolist(),
          "agg_max_abs_err": float((a_gpu - a_cpu).abs().max()),
          "params_max_abs_err": float((p_gpu - p_cpu).abs().max())})
    check(int((~row_ok).sum()) <= MAX_KINK_ROWS,
          f"{int((~row_ok).sum())} update rows differ (allowed {MAX_KINK_ROWS})")
    check(torch.allclose(a_gpu, a_cpu, **ROUND_TOL), "aggregates differ")
    check(torch.allclose(p_gpu, p_cpu, **ROUND_TOL), "new params differ")


def phase_config1(torch, trimmed, dev, card: str, log_root: Path) -> int:
    """BASELINE config 1's shape: MNIST-sized MLP, K=10, f=4, ALIE + trimmed
    mean (b=5 auto-shrunk to 4), the README quick start's run parameters."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    sim = Simulator(
        dataset=Synthetic(num_clients=10, train_bs=32, train_size=60_000,
                          test_size=10_000, cache=False),
        attack="alie", num_byzantine=4, aggregator="trimmedmean", seed=1,
        device=dev, log_path=str(log_root / "config1"),
    )
    torch.cuda.reset_peak_memory_stats()
    trimmed.trimmed_mean_launches = 0
    times = sim.run(model="mlp", global_rounds=2, local_steps=50, server_lr=1.0, client_lr=0.1)
    torch.cuda.synchronize()
    launches = trimmed.trimmed_mean_launches
    emit({"phase": "config1", "clients": 10, "byzantine": 4, "b": 4, "rounds": 2,
          "local_steps": 50, "kernel_launches": launches, "round_s": times,
          "rounds_per_s": len(times) / sum(times),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), "card": card})
    check(sim.aggregator._effective_b(10) == 4, "b did not shrink to 4 at K=10")
    check(launches == 2, f"kernel launched {launches} times in 2 rounds, want 2")
    return launches


def cct2_simulator(torch, log_root: Path):
    """CCT-2's headline population on CIFAR-shaped synthetic data (50,000 /
    10,000 samples; CIFAR-10's files are not in the repo): K=1000, f=5
    ALIE, trimmed mean b=5. No ``device=``: the port's default is the card."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.datasets import Synthetic

    k, _, b = CCT2_SHAPE
    sim = Simulator(
        dataset=Synthetic(num_clients=k, sample_shape=(32, 32, 3), train_bs=32,
                          train_size=50_000, test_size=10_000, cache=False),
        attack="alie", num_byzantine=b, aggregator="trimmedmean",
        aggregator_kws={"num_byzantine": b}, seed=1, log_path=str(log_root / "cct2_path"),
    )
    check(sim.device == torch.device("cuda"), f"the default device is {sim.device}")
    return sim


def phase_cct2_path(torch, trimmed, sim, card: str) -> dict:
    """CCT-2 through Simulator.run: CCT2_ROUNDS_F32 rounds in f32, then
    CCT2_ROUNDS_BF16 with compute_dtype="bfloat16", 1 local step of batch
    32, CCT2_CHUNKS client chunks. Each run's kernel launches are counted
    alone; the last round's own [K, D] matrix is then handed to the kernel
    and its plain version (those launches are not counted). Returns, per
    dtype, the engine, its state, the launches and that error."""
    from blades_tpu_torch.utils.logging import read_stats

    k, d, b = CCT2_SHAPE
    out = {}
    for dtype, rounds in (("float32", CCT2_ROUNDS_F32), ("bfloat16", CCT2_ROUNDS_BF16)):
        seen = []

        def on_round_end(rnd, state, m):
            u = sim.engine.last_updates
            seen.append(dict(shape=tuple(u.shape), device=u.device.type, dtype=u.dtype,
                             loss=float(m.train_loss), top1=float(m.train_top1),
                             agg_norm=float(m.agg_norm), variance=float(m.update_variance)))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trimmed.trimmed_mean_launches = 0
        times = sim.run(model="cct_2_3x2_32", global_rounds=rounds, local_steps=1,
                        server_lr=1.0, client_lr=0.1, validate_interval=rounds,
                        client_chunks=CCT2_CHUNKS, on_round_end=on_round_end,
                        compute_dtype=None if dtype == "float32" else dtype)
        torch.cuda.synchronize()
        launches = trimmed.trimmed_mean_launches
        peak = torch.cuda.max_memory_allocated()
        u = sim.engine.last_updates
        got = trimmed.trimmed_mean_cuda(u, b)
        ref = trimmed.trimmed_mean_plain(u, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        test = [r for r in read_stats(sim.log_path) if r["_meta"]["type"] == "test"][-1]
        emit({"phase": "cct2_path", "dtype": dtype, "clients": k, "byzantine": b, "b": b,
              "rounds": rounds, "client_chunks": CCT2_CHUNKS, "kernel_launches": launches,
              "updates_shape": list(seen[0]["shape"]), "updates_dtype": str(seen[0]["dtype"]),
              "train_loss": [r["loss"] for r in seen], "train_top1": [r["top1"] for r in seen],
              "agg_norm": [r["agg_norm"] for r in seen],
              "update_variance": [r["variance"] for r in seen],
              "test_loss": test["Loss"], "test_top1": test["top1"],
              "round_s": times, "note": "the last round_s includes the 10,000-sample eval",
              "peak_mem_bytes": peak, "last_round_kernel_vs_plain_max_abs_err": err,
              "card": card})
        check(launches == rounds, f"{dtype}: kernel launched {launches} times in {rounds} rounds")
        check(all(r["shape"] == (k, d) and r["device"] == "cuda" and r["dtype"] == torch.float32
                  for r in seen), f"{dtype}: update matrices {seen}")
        numbers = [v for r in seen for v in (r["loss"], r["agg_norm"], r["variance"])]
        check(all(map(math.isfinite, numbers + [test["Loss"]])), f"{dtype}: non-finite {numbers}")
        check(bool(torch.allclose(got, ref, **TOL)),
              f"{dtype}: kernel and plain version differ by {err} on the round's matrix")
        check(math.isclose(float(torch.linalg.vector_norm(got)), seen[-1]["agg_norm"],
                           rel_tol=1e-6), f"{dtype}: the round applied another aggregate")
        out[dtype] = dict(engine=sim.engine, state=sim.server.state, launches=launches,
                          max_abs_err=err)
    return out


def _union_ms(spans) -> float:
    """Length of the union of [start, end] intervals (us), in ms."""
    total, start, end = 0.0, None, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            total += 0.0 if end is None else end - start
            start, end = lo, hi
        else:
            end = max(end, hi)
    return (total + (0.0 if end is None else end - start)) / 1e3


def device_kernels(torch, prof) -> list:
    """The kernel (device) events of a profiled window."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def conv_kernel_names(torch, eng, state, cx, dtype) -> tuple:
    """(forward, all) names of the kernels that the tokenizer's two convs
    launch at one client chunk's shapes, found by profiling those convs
    alone: vmapped over the chunk with batched weights as in the round,
    forward only, then forward and backward (both weights' gradients and
    the second conv's input gradient, as the round takes them)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    cast = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    k = eng.chunk_size
    w = [state.params[f"tokenizer.convs.{i}.weight"].to(cast).expand(k, -1, -1, -1, -1)
         for i in (0, 1)]
    x = cx[:k, 0].to(cast)

    def convs(w0, w1, xb):
        h = F.max_pool2d(F.relu(F.conv2d(xb.permute(0, 3, 1, 2), w0, padding=1)), 3, 2, 1)
        return F.conv2d(h, w1, padding=1).float().sum()

    names = []
    for fn in (torch.func.vmap(convs),
               torch.func.vmap(torch.func.grad(convs, argnums=(0, 1)))):
        fn(*w, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*w, x)
            torch.cuda.synchronize()
        # PyTorch's own kernels (copies, relu, max-pool) and memsets are not
        # the conv's
        names.append({e.name for e in device_kernels(torch, prof)
                      if "at::native::" not in e.name and not e.name.startswith("Mem")})
    return names[0], names[0] | names[1]


def device_breakdown(torch, prof, conv_forward: set, conv_all: set) -> dict:
    """Device time of a profiled window from its kernel events (cuDNN runs
    a grouped conv's per-group kernels on several streams, so kernels
    overlap): busy time is the union of their intervals; each class gets
    the union and the sum of its kernels' intervals. Classes: conv forward
    and backward (kernel names from conv_kernel_names; a name the forward
    launches counts as forward wherever it runs), GEMM (cuBLAS and CUTLASS
    kernel names), max-pool, the trimmed-mean kernel, and the rest
    (elementwise work, copies, reductions, layer norm, softmax), whose
    largest kernels are listed."""
    kernels = device_kernels(torch, prof)

    def cls(name):
        if "trimmed_mean_kernel" in name:
            return "trimmed_mean_kernel"
        if name in conv_forward:
            return "conv_forward"
        if name in conv_all:
            return "conv_backward"
        if any(tag in name.lower() for tag in ("gemm", "nvjet", "cutlass", "xmma")):
            return "gemm"
        if "max_pool" in name:
            return "max_pool"
        return "other"

    spans, other = {}, {}
    for e in kernels:
        c, span = cls(e.name), (e.time_range.start, e.time_range.end)
        spans.setdefault(c, []).append(span)
        if c == "other":
            other[e.name] = other.get(e.name, 0.0) + (span[1] - span[0]) / 1e3
    classes = ("conv_forward", "conv_backward", "gemm", "max_pool", "trimmed_mean_kernel",
               "other")
    return {"busy_ms": _union_ms([sp for v in spans.values() for sp in v]),
            "kernel_sum_ms": sum(hi - lo for v in spans.values() for lo, hi in v) / 1e3,
            "streams": len({e.device_resource_id for e in kernels}),
            "by_class_union_ms": {c: _union_ms(spans.get(c, [])) for c in classes},
            "by_class_sum_ms": {c: sum(hi - lo for lo, hi in spans.get(c, [])) / 1e3
                                for c in classes},
            "other_top_ms": [[n[:110], ms] for n, ms in
                             sorted(other.items(), key=lambda kv: kv[1], reverse=True)[:8]]}


def phase_cct2_profile(torch, sim, runs: dict, card: str) -> None:
    """One warm CCT-2 round per dtype under torch.profiler: wall and device
    busy time, the busy share, device time by class (see device_breakdown),
    the top kernels by name and the conv kernels named; then the wall time
    of 3 warm rounds without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from blades_tpu_torch.utils import rng

    for dtype, run in runs.items():
        eng, state = run["engine"], run["state"]
        cx, cy = sim.dataset.sample_round(
            rng.generator(sim.seed, 99, rng.DATA, device=eng.device), 1, 32)
        conv_fwd, conv_all = conv_kernel_names(torch, eng, state, cx, dtype)
        eng.run_round(state, cx, cy, 0.1, 1.0)  # warm
        # the profiler loses device events (see profiled_block): the round
        # is profiled again, up to PROFILE_ATTEMPTS times, until the
        # kernel's launch is among its events
        kernel_seen = []
        for _ in range(PROFILE_ATTEMPTS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                eng.run_round(state, cx, cy, 0.1, 1.0)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            dev = device_breakdown(torch, prof, conv_fwd, conv_all)
            busy = dev["busy_ms"]
            kernel_seen.append(dev["by_class_union_ms"]["trimmed_mean_kernel"] > 0)
            if kernel_seen[-1]:
                break
        by_name = {}
        for e in device_kernels(torch, prof):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
        emit({"phase": "cct2_profile", "dtype": dtype, "clients": eng.num_clients,
              "client_chunks": eng.client_chunks, "wall_ms": wall_ms,
              "device_busy_share": busy / wall_ms, **dev,
              "class_union_share_of_busy": {c: v / busy for c, v in
                                            dev["by_class_union_ms"].items()} if busy else None,
              "top_kernels_ms": [[name[:110], ms, n] for name, (ms, n) in top[:12]],
              "conv_kernels_ms": [["forward" if name in conv_fwd else "backward", name[:300],
                                   ms, n] for name, (ms, n) in top if name in conv_all],
              "peak_mem_bytes": peak, "kernel_event_by_attempt": kernel_seen, "card": card})
        check(busy == 0 or kernel_seen[-1],
              f"{dtype}: the profiled round shows no trimmed-mean kernel in "
              f"{len(kernel_seen)} attempts")
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.run_round(state, cx, cy, 0.1, 1.0)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        emit({"phase": "cct2_warm_rounds", "dtype": dtype, "round_ms": warm,
              "median_ms": sorted(warm)[1], "card": card})


def phase_cct2_card_vs_cpu(torch, dev) -> None:
    """One CCT-2 round (full width, attention dropout and DropPath at their
    default rates) on the card and on the CPU from the same params, the
    same batches and the same keep-masks: the masks are drawn once on the
    CPU and handed to both engines in place of their own draw, since CUDA
    and CPU generators give different streams. The aggregate and the new
    params within ROUND_TOL; every update row within ROUND_TOL but for at
    most CCT2_MAX_KINK_ROWS, which are reported."""
    from blades_tpu_torch.aggregators import Trimmedmean
    from blades_tpu_torch.attackers import Alie
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.models import build_fns, create_model
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.utils import rng

    k, f = CCT2_CPU_CLIENTS, CCT2_CPU_BYZANTINE
    spec = build_fns(create_model("cct_2_3x2_32", sample_shape=(32, 32, 3)))
    params = spec.init(torch.Generator().manual_seed(21))
    ds = Synthetic(num_clients=k, sample_shape=(32, 32, 3), train_bs=32, train_size=2_000,
                   test_size=100, cache=False).get_dls("cpu")
    cx, cy = ds.sample_round(torch.Generator().manual_seed(22), 1, 32)
    masks = rng.keep_masks(spec.noise_sites(32), torch.Generator().manual_seed(23), (k,))
    drawn = rng.keep_masks

    def same_masks(sites, generator, lead=()):
        check(list(sites) == list(masks) and tuple(lead) == (k,), f"mask sites {list(sites)}")
        return {n: m.to(generator.device) for n, m in masks.items()}

    out = {}
    rng.keep_masks = same_masks
    try:
        for where in ("cpu", dev):
            eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                              num_clients=k, num_byzantine=f,
                              attack=Alie(num_clients=k, num_byzantine=f),
                              aggregator=Trimmedmean(num_byzantine=f), device=where,
                              noise_sites=spec.noise_sites)
            state, _ = eng.run_round(eng.init(params), cx.to(where), cy.to(where), 0.1, 1.0)
            agg, _ = eng.aggregator.aggregate(eng.last_updates)  # what the round applied
            out[str(where)] = (eng.last_updates.cpu(), agg.cpu(),
                               ravel(state.params, spec.layout).cpu())
    finally:
        rng.keep_masks = drawn
    (u_cpu, a_cpu, p_cpu), (u_gpu, a_gpu, p_gpu) = out["cpu"], out[str(dev)]
    row_ok = torch.isclose(u_gpu, u_cpu, **ROUND_TOL).all(dim=1)
    emit({"phase": "cct2_card_vs_cpu_round", "clients": k, "byzantine": f, "b": f,
          "dim": u_cpu.shape[1], "tol": ROUND_TOL, "mask_sites": list(masks),
          "updates_max_abs_err": float((u_gpu - u_cpu).abs().max()),
          "updates_max_abs": float(u_cpu.abs().max()),
          "update_rows_outside_tol": torch.nonzero(~row_ok).flatten().tolist(),
          "agg_max_abs_err": float((a_gpu - a_cpu).abs().max()),
          "params_max_abs_err": float((p_gpu - p_cpu).abs().max())})
    check(int((~row_ok).sum()) <= CCT2_MAX_KINK_ROWS,
          f"{int((~row_ok).sum())} update rows differ (allowed {CCT2_MAX_KINK_ROWS})")
    check(torch.allclose(a_gpu, a_cpu, **ROUND_TOL), "CCT-2 aggregates differ")
    check(torch.allclose(p_gpu, p_cpu, **ROUND_TOL), "CCT-2 new params differ")


def catalog_kwargs(aggregator: str) -> dict:
    """Constructor arguments of a catalog aggregator: f=5 where it takes f
    (trimmed mean's default b is 5)."""
    return {"num_byzantine": MAIN_BYZANTINE} if aggregator in ("krum", "multikrum", "dnc") else {}


def host_syncs(torch, fn) -> dict:
    """The synchronizing CUDA calls one call of ``fn`` makes, counted by
    PyTorch's sync debug mode (one warning each; the mode's own one-time
    notice that it is a prototype is not one): ``{"file:line": n}`` of the
    Python lines that made them."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "called a synchronizing CUDA operation" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def call_cost(torch, fn) -> dict:
    """One function's cost on the card: device time per call (CUDA events;
    1 call if it takes over 50 ms, else the mean of 10 after 2 more), host
    syncs per call and where they happen, and the peak memory it allocates
    above what was allocated before it."""
    sites = host_syncs(torch, fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = time_ms(fn, reps=1, warmup=0)
    extra = torch.cuda.max_memory_allocated() - base
    if ms < 50.0:
        ms = time_ms(fn, reps=10, warmup=2)
    return {"ms": ms, "host_syncs": sum(sites.values()), "host_sync_sites": sites,
            "peak_extra_bytes": extra}


def catalog_run(torch, trimmed, fl, log_root: Path, attack: str, aggregator: str,
                rounds: int = CATALOG_ROUNDS, fault_model=None) -> dict:
    """``rounds`` of the CCT-2 round at K=1000 in bf16 through Simulator.run
    (4 client chunks, no evaluation; with ``fault_model``, under it), the
    kernel's launches counted alone; returns the simulator, its per-round
    metrics (and fault counters), the round times, the launches and the
    peak memory."""
    from blades_tpu_torch import Simulator

    # an engine holds itself in a reference cycle (its loss closure), so a
    # deleted run's [K, D] matrix lingers until the collector runs; collect
    # it, so that this run's peak memory is its own
    gc.collect()
    k, d, f = CCT2_SHAPE
    name = f"{attack}+{aggregator}" + ("" if fault_model is None else "+faults")
    sim = Simulator(dataset=fl, attack=attack, num_byzantine=f, aggregator=aggregator,
                    aggregator_kws=catalog_kwargs(aggregator), seed=1,
                    log_path=str(log_root / (f"catalog_{attack}_{aggregator}" + (
                        "" if fault_model is None else f"_faults_{fault_model.corrupt_mode}"))))
    check(sim.device.type == fl.device.type, f"{name}: the simulator runs on {sim.device}")
    if aggregator == "fltrust":
        sim.set_trusted_clients([sim.get_clients()[-1].id()])
    seen = []

    def on_round_end(rnd, state, m):
        u = sim.engine.last_updates
        seen.append(dict(shape=tuple(u.shape), device=u.device.type, dtype=u.dtype,
                         loss=float(m.train_loss), agg_norm=float(m.agg_norm),
                         variance=float(m.update_variance)))
        if fault_model is not None:
            seen[-1]["faults"] = {n: int(v) for n, v in sim.engine.last_fault_diag.items()}
            # corrupt clients whose row arrived non-finite: those that delivered
            seen[-1]["nonfinite_corrupt_rows"] = sum(
                not bool(torch.isfinite(u[c]).all()) for c in fault_model.corrupt_clients)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trimmed.trimmed_mean_launches = 0
    times = sim.run(model="cct_2_3x2_32", global_rounds=rounds, local_steps=1,
                    server_lr=1.0, client_lr=0.1, validate_interval=rounds + 1,
                    client_chunks=CCT2_CHUNKS, on_round_end=on_round_end,
                    compute_dtype="bfloat16", fault_model=fault_model)
    torch.cuda.synchronize()
    launches = trimmed.trimmed_mean_launches
    peak = torch.cuda.max_memory_allocated()
    check(len(seen) == rounds, f"{name}: {len(seen)} rounds")
    check(all(r["shape"] == (k, d) and r["device"] == sim.device.type
              and r["dtype"] == torch.float32 for r in seen), f"{name}: update matrices {seen}")
    numbers = [v for r in seen for v in (r["loss"], r["agg_norm"], r["variance"])]
    check(all(map(math.isfinite, numbers)), f"{name}: non-finite {numbers}")
    return dict(sim=sim, seen=seen, round_s=times, launches=launches, peak=peak)


def phase_catalog_attacks(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """Each catalog attack with trimmed mean (b=5): CATALOG_ROUNDS bf16
    CCT-2 rounds at K=1000, then the attack's own hook timed at the round's
    shapes: on_updates on the round's [K, D] matrix; on_grads on one client
    chunk's gradients (a round calls it once per chunk and local step);
    on_batch on one chunk's batch. Returns the kernel's launches per run."""
    from blades_tpu_torch.utils import rng

    k, d, f = CCT2_SHAPE
    launches = {}
    for attack in CATALOG_ATTACKS:
        run = catalog_run(torch, trimmed, fl, log_root, attack, "trimmedmean")
        sim = run["sim"]
        eng = sim.engine
        chunk = eng.chunk_size
        byz = eng.byz_mask
        if attack == "signflipping":
            grads = {n: torch.randn(chunk, *p.shape, device=eng.device)
                     for n, p in sim.server.state.params.items()}
            hook = "on_grads"
            cost = call_cost(torch, lambda: sim.attack.on_grads(grads, byz[:chunk]))
            del grads
        elif attack == "labelflipping":
            cx, cy = fl.sample_round(rng.generator(sim.seed, 99, rng.DATA, device=eng.device),
                                     1, 32)
            hook = "on_batch"
            cost = call_cost(torch, lambda: sim.attack.on_batch(
                cx[:chunk, 0], cy[:chunk, 0], byz[:chunk], num_classes=eng.num_classes))
            del cx, cy
        else:
            u = eng.last_updates
            hook = "on_updates"
            cost = call_cost(torch, lambda: sim.attack.on_updates(
                u, byz, rng.generator(sim.seed, 99, rng.ATTACK, device=eng.device)))
            del u
        calls = eng.client_chunks if hook != "on_updates" else 1
        emit({"phase": "catalog_attack", "attack": attack, "aggregator": "trimmedmean",
              "dtype": "bfloat16", "clients": k, "byzantine": f, "b": f,
              "rounds": CATALOG_ROUNDS, "client_chunks": eng.client_chunks,
              "kernel_launches": run["launches"], "round_s": run["round_s"],
              "warm_round_s": run["round_s"][-1],
              "train_loss": [r["loss"] for r in run["seen"]],
              "agg_norm": [r["agg_norm"] for r in run["seen"]],
              "peak_mem_bytes": run["peak"], "hook": hook, "hook_calls_per_round": calls,
              "hook_shape": [chunk] if hook != "on_updates" else [k, d],
              **{f"hook_{n}": v for n, v in cost.items()}, "card": card})
        check(run["launches"] == CATALOG_ROUNDS,
              f"{attack}: kernel launched {run['launches']} times in {CATALOG_ROUNDS} rounds")
        launches[f"cct2_bf16_{attack}"] = run["launches"]
        del run, sim, eng
    return launches


def phase_catalog_aggregators(torch, trimmed, fl, card: str, log_root: Path):
    """Each catalog aggregator under ALIE (f=5): CATALOG_ROUNDS bf16 CCT-2
    rounds at K=1000, then the aggregator timed alone on the run's own
    [1000, 283723] matrix with the run's state; for a stateless one, the
    aggregate of the last round is recomputed from that matrix and held to
    the round's agg_norm. Returns the first CATALOG_CPU_SHAPE of the last
    run's matrix, on the CPU, for the card-vs-CPU phase."""
    from blades_tpu_torch.utils import rng

    k, d, f = CCT2_SHAPE
    rows, cols = CATALOG_CPU_SHAPE
    sample = None
    for aggregator in CATALOG_AGGREGATORS:
        run = catalog_run(torch, trimmed, fl, log_root, "alie", aggregator)
        sim = run["sim"]
        eng, agg = sim.engine, sim.aggregator
        u, state = eng.last_updates, sim.server.state.agg_state
        round_iters = getattr(agg, "last_iterations", None)
        ctx = dict(trusted_mask=eng.trusted_mask)
        applied = None
        if not agg.stateful:
            # what the last round applied: the same matrix, state and generator
            again, _ = agg.aggregate(u, (), generator=rng.generator(
                sim.seed, CATALOG_ROUNDS - 1, rng.AGG, device=eng.device), **ctx)
            applied = float(torch.linalg.vector_norm(again))
        cost = call_cost(torch, lambda: agg.aggregate(u, state, generator=rng.generator(
            sim.seed, 99, rng.AGG, device=eng.device), **ctx))
        emit({"phase": "catalog_aggregator", "aggregator": aggregator,
              "kwargs": catalog_kwargs(aggregator), "attack": "alie", "dtype": "bfloat16",
              "clients": k, "byzantine": f, "rounds": CATALOG_ROUNDS,
              "client_chunks": eng.client_chunks, "kernel_launches": run["launches"],
              "round_s": run["round_s"], "warm_round_s": run["round_s"][-1],
              "train_loss": [r["loss"] for r in run["seen"]],
              "agg_norm": [r["agg_norm"] for r in run["seen"]],
              "recomputed_agg_norm": applied, "peak_mem_bytes": run["peak"],
              "iterations_last_round": round_iters,
              "iterations_timed_call": getattr(agg, "last_iterations", None),
              "trusted_clients": int(eng.trusted_mask.sum()),
              **{f"aggregate_{n}": v for n, v in cost.items()}, "card": card})
        if applied is not None:
            check(math.isclose(applied, run["seen"][-1]["agg_norm"], rel_tol=1e-5),
                  f"{aggregator}: the round applied another aggregate")
        if aggregator == "fltrust":
            check(int(eng.trusted_mask.sum()) == 1, "fltrust: no trusted client reached it")
        if aggregator == "geomed":
            # the counter sees the stopping rule's one read per test
            check(cost["host_syncs"] == agg.last_iterations + 1,
                  f"geomed: {cost['host_syncs']} syncs in {agg.last_iterations} iterations")
        sample = u[:rows, :cols].cpu()
        del run, sim, eng, agg, u, state
    return sample


def _compare(torch, name: str, got, ref, tol: dict, phase: str = "catalog_card_vs_cpu",
             **extra) -> None:
    err = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, **tol))
    emit({"phase": phase, "module": name, "max_abs_err": err,
          "max_abs": float(ref.abs().max()), "tol": tol, "ok": ok, **extra})
    check(ok, f"{name}: card and CPU differ by {err} (tol {tol})")


def phase_catalog_card_vs_cpu(torch, x_cpu, dev) -> None:
    """Every catalog attack and aggregator on the card and on the CPU, on
    the same [100, 16384] matrix (the first rows and columns of a CCT-2
    round's; its first 5 rows are ALIE's one vector) with the same draws
    (one CPU generator per side, seeded alike: the port draws on the
    generator's device). Tolerances: TOL, and LOOP_TOL for GeoMed and
    AutoGM. Tie rules: Krum may pick another row among rows that are
    identical (equal scores up to rounding), so the selected rows must be
    equal in content; Min-Max and Min-Sum may take another branch at a
    bisection step whose comparison is within rounding, which moves gamma
    by at most 2 * gamma_init / 2^n_bisect, and their byzantine rows by that
    times |dev|; clustering's partitions must be identical when both sides
    link the same matrix, and the aggregates within TOL."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.attackers import get_attack
    from blades_tpu_torch.ops.clustering import complete_linkage_two_clusters

    rows, cols = x_cpu.shape
    f = MAIN_BYZANTINE
    sides = {"cpu": x_cpu, "cuda": x_cpu.to(dev)}
    byz = {w: (torch.arange(rows) < f).to(x.device) for w, x in sides.items()}
    shape = dict(rows=rows, cols=cols, byzantine=f)

    for name in ("ipm", "noise", "minmax", "minsum"):
        attack = get_attack(name)
        out = {w: attack.on_updates(x, byz[w], torch.Generator().manual_seed(31))[0].cpu()
               for w, x in sides.items()}
        if name in ("minmax", "minsum"):
            g = {w: attack.gamma(x, byz[w]) for w, x in sides.items()}
            gamma = {w: float(v[0]) for w, v in g.items()}
            allowed = 2 * attack.gamma_init / 2**attack.n_bisect
            dgamma = abs(gamma["cuda"] - gamma["cpu"])
            dev_row = g["cpu"][2].abs()
            slack = TOL["atol"] + TOL["rtol"] * out["cpu"].abs() + dgamma * dev_row
            ok = dgamma <= allowed and bool(((out["cuda"] - out["cpu"]).abs() <= slack).all())
            emit({"phase": "catalog_card_vs_cpu", "module": name, "gamma": gamma,
                  "gamma_allowance": allowed, "ok": ok,
                  "max_abs_err": float((out["cuda"] - out["cpu"]).abs().max()), **shape})
            check(ok, f"{name}: gamma {gamma} (allowance {allowed})")
        else:
            _compare(torch, name, out["cuda"], out["cpu"], TOL, **shape)

    grads = {"w": x_cpu[:, :64].reshape(rows, 8, 8), "b": x_cpu[:, 64:72]}
    flipped = {w: get_attack("signflipping").on_grads(
        {n: g.to(x.device) for n, g in grads.items()}, byz[w]) for w, x in sides.items()}
    for n in grads:
        _compare(torch, f"signflipping.{n}", flipped["cuda"][n].cpu(), flipped["cpu"][n],
                 dict(rtol=0.0, atol=0.0), **shape)
    labels = (x_cpu[:, :32].abs() * 1e4).long() % 10
    flips = {w: get_attack("labelflipping").on_batch(x, labels.to(x.device), byz[w],
                                                      num_classes=10)[1].cpu()
             for w, x in sides.items()}
    _compare(torch, "labelflipping", flips["cuda"], flips["cpu"], dict(rtol=0.0, atol=0.0),
             **shape)

    trusted = {w: torch.arange(rows, device=x.device) == rows - 1 for w, x in sides.items()}
    for name in CATALOG_AGGREGATORS:
        kws = catalog_kwargs(name)
        aggs = {w: get_aggregator(name, **kws) for w in sides}
        if aggs["cpu"].stateful:
            # three rounds, the last two scaled so that rows reach and pass
            # the default clip radius (10); the state is compared after each
            med = float(torch.linalg.vector_norm(x_cpu, dim=1).median())
            scales = (1.0, 10.0 / med, 30.0 / med)
            states = {w: a.init_state(rows, cols) for w, a in aggs.items()}
            for rnd, scale in enumerate(scales):
                res = {w: aggs[w].aggregate(x * scale, states[w]) for w, x in sides.items()}
                states = {w: r[1] for w, r in res.items()}
                _compare(torch, f"{name}.round{rnd}", res["cuda"][0].cpu(), res["cpu"][0], TOL,
                         **shape)
                if name == "centeredclipping":
                    _compare(torch, f"{name}.state{rnd}", states["cuda"].cpu(), states["cpu"],
                             TOL, **shape)
                else:
                    _compare(torch, f"{name}.norms{rnd}", states["cuda"]["norms"].cpu(),
                             states["cpu"]["norms"], TOL, **shape)
                    check(all(int(states["cuda"][key]) == int(states["cpu"][key])
                              for key in ("pos", "count")), f"{name}: ring pointers differ")
            continue
        out = {w: aggs[w].aggregate(x, (), trusted_mask=trusted[w],
                                    generator=torch.Generator().manual_seed(41))[0].cpu()
               for w, x in sides.items()}
        extra = dict(shape)
        if name in ("krum", "multikrum"):
            sel = {w: aggs[w]._select(x)[1].cpu() for w, x in sides.items()}
            same_rows = torch.equal(x_cpu[sel["cuda"]], x_cpu[sel["cpu"]])
            extra.update(selected={w: s.tolist() for w, s in sel.items()},
                         selected_rows_equal=same_rows)
            check(same_rows, f"{name}: selected rows differ in content {sel}")
        if name == "clustering":
            m_cpu = aggs["cpu"]._matrix(x_cpu)
            lab = {w: complete_linkage_two_clusters(m_cpu.to(x.device)).cpu()
                   for w, x in sides.items()}
            own = {w: complete_linkage_two_clusters(aggs[w]._matrix(x)).cpu()
                   for w, x in sides.items()}
            extra.update(same_matrix_partition_equal=torch.equal(lab["cuda"], lab["cpu"]),
                         own_matrix_partition_equal=torch.equal(own["cuda"], own["cpu"]),
                         cluster_sizes=[int((own["cpu"] == c).sum()) for c in (0, 1)])
            check(torch.equal(lab["cuda"], lab["cpu"]), "clustering: linkage partitions differ")
        if name in ("geomed", "autogm"):
            extra.update(iterations={w: aggs[w].last_iterations for w in sides})
        _compare(torch, name, out["cuda"], out["cpu"],
                 LOOP_TOL if name in ("geomed", "autogm") else TOL, **extra)


def recording_fault_model(**kw):
    """A FaultModel that keeps its last participation mask as
    ``last_mask``: the engine reports only the counters, and the phases
    time each defense on the round's own matrix and mask."""
    from blades_tpu_torch.faults import FaultModel

    class Recording(FaultModel):
        def apply(self, *args, **kwargs):
            out = super().apply(*args, **kwargs)
            self.__dict__["last_mask"] = out[1]
            return out

    return Recording(**kw)


def rank_form_trimmed_mean(torch, updates, mask, b: int):
    """The JAX package's masked trimmed mean as written there
    (``blades_tpu/ops/masked.py:57``): each row's rank per column from two
    stable argsorts of the sentinel matrix, the survivors summed in row
    order. Timed beside the port's one-sort form and held to it."""
    n = mask.sum()
    b_eff = torch.clamp(torch.clamp_min((n - 1) // 2, 0), max=b)
    sentinel = torch.where(mask[:, None], updates, float("inf"))
    ranks = torch.argsort(torch.argsort(sentinel, dim=0, stable=True), dim=0, stable=True)
    keep = (ranks >= b_eff) & (ranks < n - b_eff)
    return torch.where(keep, updates, 0.0).sum(dim=0) / torch.clamp_min(n - 2 * b_eff, 1)


def check_fault_run(torch, run, name: str, mode: str) -> list:
    """Each round's fault counters; the in-program checks of a fault run:
    finite params, the non-finite guard excluding exactly the corrupt
    clients that delivered (NaN mode) or nothing (bit-flip mode)."""
    from blades_tpu_torch.ops.pytree import ravel

    eng = run["sim"].engine
    faults = [dict(r["faults"], nonfinite_corrupt_rows=r["nonfinite_corrupt_rows"])
              for r in run["seen"]]
    params = ravel(run["sim"].server.state.params, eng.layout)
    check(bool(torch.isfinite(params).all()), f"{name}: non-finite params")
    for rnd, f in enumerate(faults):
        expect = f["nonfinite_corrupt_rows"] if mode == "nan" else 0
        check(f["excluded_nonfinite"] == expect, f"{name} round {rnd}: {f}")
        check(f["corrupted"] == f["nonfinite_corrupt_rows"] if mode == "nan"
              else f["nonfinite_corrupt_rows"] == 0, f"{name} round {rnd}: {f}")
        check(f["participants"] + f["dropped"] + f["stragglers_expired"]
              + f["excluded_nonfinite"] == eng.num_clients, f"{name} round {rnd}: {f}")
    return faults


def phase_fault_round(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """Trimmed mean (b=5) under the fault model: FAULT_ROUNDS bf16 CCT-2
    rounds at K=1000 with NaN corruption, then FAULT_BITFLIP_ROUNDS with
    bit-flip corruption. Checks: a straggler replays in a round after the
    first, the guard excludes the corrupt clients that delivered, the
    params stay finite, the kernel does not launch (the masked form
    replaces it), and the round applied the masked trimmed mean. Times, on
    the NaN run's last received matrix and mask: the masked trimmed mean
    (the port's one-sort form and the JAX package's two-argsort form,
    held to each other), the kernel on the same matrix with masked-out rows
    zeroed, and FaultModel.apply. Returns the kernel's launches per run."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.ops.masked import masked_trimmed_mean
    from blades_tpu_torch.utils import rng

    k, d, b = CCT2_SHAPE
    launches = {}
    for mode, rounds in (("nan", FAULT_ROUNDS), ("bitflip", FAULT_BITFLIP_ROUNDS)):
        fm = recording_fault_model(**FAULTS, corrupt_mode=mode)
        run = catalog_run(torch, trimmed, fl, log_root, "alie", "trimmedmean", rounds=rounds,
                          fault_model=fm)
        sim = run["sim"]
        eng = sim.engine
        name = f"fault_round[{mode}]"
        faults = check_fault_run(torch, run, name, mode)
        launches[f"cct2_bf16_faults_{mode}"] = run["launches"]
        rec = {"phase": "fault_round", "corrupt_mode": mode, "fault_model": repr(fm),
               "aggregator": "trimmedmean", "attack": "alie", "dtype": "bfloat16",
               "clients": k, "byzantine": b, "b": b, "rounds": rounds,
               "client_chunks": eng.client_chunks, "kernel_launches": run["launches"],
               "faults_by_round": faults, "round_s": run["round_s"],
               "warm_round_s": run["round_s"][-1],
               "train_loss": [r["loss"] for r in run["seen"]],
               "agg_norm": [r["agg_norm"] for r in run["seen"]],
               "peak_mem_bytes": run["peak"]}
        check(run["launches"] == 0, f"{name}: the kernel launched {run['launches']} times")
        if mode == "nan":
            check(any(f["stale_replayed"] > 0 for f in faults[1:]),
                  f"{name}: no straggler replayed after the first round: {faults}")
            u, mask = eng.last_updates, fm.last_mask
            agg = get_aggregator("trimmedmean", num_byzantine=b)
            applied, _ = agg.aggregate_masked(u, (), mask=mask)
            check(math.isclose(float(torch.linalg.vector_norm(applied)),
                               run["seen"][-1]["agg_norm"], rel_tol=1e-6),
                  f"{name}: the round applied another aggregate")
            safe = torch.where(mask[:, None], u, 0.0)
            slot = masked_trimmed_mean(safe, mask, b)
            rank = rank_form_trimmed_mean(torch, safe, mask, b)
            torch.cuda.synchronize()
            err = float((slot - rank).abs().max())
            check(bool(torch.allclose(slot, rank, **TOL)),
                  f"{name}: the one-sort and the two-argsort forms differ by {err}")
            state = sim.server.state.fault_state
            costs = {
                "masked_trimmed_mean": call_cost(torch, lambda: agg.aggregate_masked(
                    u, (), mask=mask)),
                "masked_trimmed_mean_rank_form": call_cost(
                    torch, lambda: rank_form_trimmed_mean(torch, safe, mask, b)),
                "kernel_on_zeroed_matrix": call_cost(
                    torch, lambda: trimmed.trimmed_mean_cuda(safe, b)),
                "fault_apply": call_cost(torch, lambda: fm.apply(
                    safe, state, rng.generator(sim.seed, 99, rng.FAULT, device=eng.device),
                    99)),
            }
            for what in ("masked_trimmed_mean", "fault_apply"):
                check(costs[what]["host_syncs"] == 0, f"{name}: {what} syncs {costs[what]}")
            rec.update(participants_last_round=int(mask.sum()), slot_vs_rank_max_abs_err=err,
                       **{f"{w}_{n}": v for w, c in costs.items() for n, v in c.items()})
            del u, mask, safe, state, slot, rank
        else:
            check(sum(f["corrupted"] for f in faults) > 0, f"{name}: nothing was corrupted")
        emit(dict(rec, card=card))
        del run, sim, eng
    return launches


def phase_fault_aggregators(torch, trimmed, fl, card: str, log_root: Path):
    """Each other registered aggregator under ALIE (f=5) and the fault model
    (NaN corruption): FAULT_AGG_ROUNDS bf16 CCT-2 rounds at K=1000, then
    its masked form timed alone on the last round's received matrix and
    mask with the run's state, beside its dense form on the same matrix
    with the masked-out rows zeroed; host syncs, iterations and extra peak
    memory of each. A stateless one's last aggregate is recomputed and held
    to the round's agg_norm. Then DecentralizedMixing and AnchorClipping
    (ring, Metropolis weights) alone on that matrix. Returns the first
    CATALOG_CPU_SHAPE of the last run's zeroed matrix and its mask's first
    rows, on the CPU, for fault_card_vs_cpu."""
    from blades_tpu_torch.aggregators import decentralized
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.utils import rng

    k, d, f = CCT2_SHAPE
    rows, cols = CATALOG_CPU_SHAPE
    sample = None
    for aggregator in FAULT_AGGREGATORS:
        fm = recording_fault_model(**FAULTS)
        run = catalog_run(torch, trimmed, fl, log_root, "alie", aggregator,
                          rounds=FAULT_AGG_ROUNDS, fault_model=fm)
        sim = run["sim"]
        eng, agg = sim.engine, sim.aggregator
        faults = check_fault_run(torch, run, f"fault_aggregator[{aggregator}]", "nan")
        u, mask, state = eng.last_updates, fm.last_mask, sim.server.state.agg_state
        safe = torch.where(mask[:, None], u, 0.0)
        round_iters = getattr(agg, "last_iterations", None)
        ctx = dict(trusted_mask=eng.trusted_mask,
                   params_flat=ravel(sim.server.state.params, eng.layout))
        applied = None
        if not agg.stateful:
            again, _ = agg.aggregate_masked(u, (), mask=mask, generator=rng.generator(
                sim.seed, FAULT_AGG_ROUNDS - 1, rng.AGG, device=eng.device), **ctx)
            applied = float(torch.linalg.vector_norm(again))

        def gen():
            return rng.generator(sim.seed, 99, rng.AGG, device=eng.device)

        masked = call_cost(torch, lambda: agg.aggregate_masked(u, state, mask=mask,
                                                               generator=gen(), **ctx))
        masked_iters = getattr(agg, "last_iterations", None)
        dense = call_cost(torch, lambda: agg.aggregate(safe, state, generator=gen(), **ctx))
        emit({"phase": "fault_aggregator", "aggregator": aggregator,
              "kwargs": catalog_kwargs(aggregator), "attack": "alie", "dtype": "bfloat16",
              "fault_model": repr(fm), "clients": k, "byzantine": f, "rounds": FAULT_AGG_ROUNDS,
              "client_chunks": eng.client_chunks, "kernel_launches": run["launches"],
              "faults_by_round": faults, "participants_last_round": int(mask.sum()),
              "round_s": run["round_s"], "warm_round_s": run["round_s"][-1],
              "train_loss": [r["loss"] for r in run["seen"]],
              "agg_norm": [r["agg_norm"] for r in run["seen"]],
              "recomputed_agg_norm": applied, "peak_mem_bytes": run["peak"],
              "iterations_last_round": round_iters, "iterations_timed_masked": masked_iters,
              "iterations_timed_dense": getattr(agg, "last_iterations", None),
              **{f"masked_{n}": v for n, v in masked.items()},
              **{f"dense_{n}": v for n, v in dense.items()}, "card": card})
        if applied is not None:
            check(math.isclose(applied, run["seen"][-1]["agg_norm"], rel_tol=1e-5),
                  f"{aggregator}: the round applied another aggregate")
        if aggregator not in ("geomed", "autogm"):
            check(masked["host_syncs"] == 0, f"{aggregator}: masked form syncs {masked}")
        if aggregator == "geomed":
            check(masked["host_syncs"] == masked_iters + 1,
                  f"geomed: {masked['host_syncs']} syncs in {masked_iters} iterations")
        if aggregator == "signguard":
            # the gossip aggregators, alone on this round's zeroed matrix
            w = decentralized.metropolis_weights(decentralized.ring_adjacency(k))
            mixing = decentralized.DecentralizedMixing(w)
            anchor = decentralized.AnchorClipping(w)
            # the first calls copy the mixing matrix to the card, once
            mixing.mix(safe)
            anchors = anchor.aggregate(safe, anchor.init_state(k, d))[1]
            for gossip, fn in (("DecentralizedMixing", lambda: mixing.mix(safe)),
                               ("AnchorClipping", lambda: anchor.aggregate(safe, anchors))):
                cost = call_cost(torch, fn)
                emit({"phase": "fault_gossip", "module": gossip, "topology": "ring",
                      "clients": k, "dim": d, **cost, "card": card})
                check(cost["host_syncs"] == 0, f"{gossip}: syncs {cost}")
            del anchors
        sample = (safe[:rows, :cols].cpu(), mask[:rows].cpu())
        del run, sim, eng, agg, u, mask, state, safe
    return sample


def phase_fault_card_vs_cpu(torch, x_cpu, mask_cpu, dev) -> None:
    """Every registered aggregator's masked form and FaultModel.apply on the
    card and on the CPU, on the same [100, 16384] matrix (a fault round's,
    masked-out rows zeroed; its first 5 rows are ALIE's one vector) and the
    same mask (that round's first 100 entries), with the same draws: one
    CPU generator per side for DnC, and the fault draws made once on the
    CPU and handed to both. Tolerances: TOL, LOOP_TOL for GeoMed and AutoGM;
    the fault model's received matrix, mask, counters and straggler buffer
    bit for bit, over 2 rounds in each corruption mode."""
    from blades_tpu_torch.aggregators import AGGREGATORS, get_aggregator
    from blades_tpu_torch.faults import FaultModel, draw_faults

    rows, cols = x_cpu.shape
    check(0 < int(mask_cpu.sum()) < rows, f"mask has {int(mask_cpu.sum())} of {rows}")
    sides = {"cpu": (x_cpu, mask_cpu), "cuda": (x_cpu.to(dev), mask_cpu.to(dev))}
    params = torch.randn(cols, generator=torch.Generator().manual_seed(51))
    trusted = int(torch.nonzero(mask_cpu).max())  # FLTrust's: the last participant
    shape = dict(rows=rows, cols=cols, participants=int(mask_cpu.sum()))
    for name in sorted(AGGREGATORS):
        aggs = {w: get_aggregator(name, **catalog_kwargs(name)) for w in sides}
        out, states = {}, {}
        for w, (x, m) in sides.items():
            got, states[w] = aggs[w].aggregate_masked(
                x, aggs[w].init_state(rows, cols), mask=m,
                trusted_mask=torch.arange(rows, device=x.device) == trusted,
                params_flat=params.to(x.device), generator=torch.Generator().manual_seed(41))
            out[w] = got.cpu()
        tol = LOOP_TOL if name in ("geomed", "autogm") else TOL
        _compare(torch, name, out["cuda"], out["cpu"], tol, phase="fault_card_vs_cpu", **shape)
        if aggs["cpu"].stateful:
            lt = torch.utils._pytree.tree_leaves
            for i, (a, b) in enumerate(zip(lt(states["cuda"]), lt(states["cpu"]))):
                a = a.cpu()
                if a.dtype.is_floating_point:
                    _compare(torch, f"{name}.state{i}", a, b, TOL, phase="fault_card_vs_cpu",
                             **shape)
                else:
                    check(torch.equal(a, b), f"{name}: state leaf {i} differs")

    for mode in ("nan", "inf", "bitflip"):
        fm = FaultModel(**dict(FAULTS, dropout_rate=0.2, straggler_rate=0.3), corrupt_mode=mode)
        states = {w: fm.init_state(rows, cols, device=x.device) for w, (x, _) in sides.items()}
        for rnd in range(2):
            draws = draw_faults(fm, rows, cols, torch.Generator().manual_seed(61 + rnd))
            res = {}
            for w, (x, _) in sides.items():
                out, m, states[w], diag = fm.apply(x * (1 + rnd), states[w], None, rnd,
                                                   draws=draws)
                res[w] = (out.cpu(), m.cpu(), {n: int(v) for n, v in diag.items()})
            same_out = bool((res["cuda"][0] == res["cpu"][0]).logical_or(
                res["cuda"][0].isnan() & res["cpu"][0].isnan()).all())
            same_state = all(torch.equal(states["cuda"][n].cpu(), states["cpu"][n])
                             for n in ("stale", "age", "has"))
            ok = (same_out and same_state and torch.equal(res["cuda"][1], res["cpu"][1])
                  and res["cuda"][2] == res["cpu"][2])
            emit({"phase": "fault_card_vs_cpu", "module": f"FaultModel.apply[{mode}]",
                  "round": rnd, "faults": res["cpu"][2], "ok": ok, **shape})
            check(ok, f"FaultModel.apply[{mode}] round {rnd}: card and CPU differ")


def stream_run(torch, trimmed, fl, log_root: Path, aggregator: str, rounds: int,
               streaming: bool, fault_model=None, chunks: int = CCT2_CHUNKS) -> dict:
    """``rounds`` bf16 CCT-2 rounds through Simulator.run on the store
    ``fl`` (its K), sign flipping f=5, in ``chunks`` client chunks,
    streaming or dense, no evaluation. ``run(streaming=True)`` refuses
    ``on_round_end``, so each round's metrics (and fault counters) are read
    where the simulator logs them. Returns the simulator, the per-round
    records, the round times, the kernel's launches and the peak memory."""
    from blades_tpu_torch import Simulator

    gc.collect()
    f = MAIN_BYZANTINE
    mode = "stream" if streaming else "dense"
    sim = Simulator(dataset=fl, attack="signflipping", num_byzantine=f, aggregator=aggregator,
                    aggregator_kws=catalog_kwargs(aggregator), seed=1,
                    log_path=str(log_root / f"{mode}_{aggregator}_{fl.num_clients}"))
    check(sim.device.type == fl.device.type, f"{aggregator}: the simulator runs on {sim.device}")
    seen, log_train = [], sim.log_train

    def record(rnd, local_steps, m):
        log_train(rnd, local_steps, m)
        seen.append(dict(loss=float(m.train_loss), agg_norm=float(m.agg_norm),
                         variance=float(m.update_variance)))
        if fault_model is not None:
            seen[-1]["faults"] = {n: int(v) for n, v in sim.engine.last_fault_diag.items()}

    sim.log_train = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trimmed.trimmed_mean_launches = 0
    times = sim.run(model="cct_2_3x2_32", global_rounds=rounds, local_steps=1, server_lr=1.0,
                    client_lr=0.1, validate_interval=rounds + 1, client_chunks=chunks,
                    compute_dtype="bfloat16", fault_model=fault_model, streaming=streaming)
    torch.cuda.synchronize()
    launches = trimmed.trimmed_mean_launches
    peak = torch.cuda.max_memory_allocated()
    check(sim.engine.streaming == streaming and sim.engine.last_updates is None,
          f"{aggregator}: the engine's streaming is {sim.engine.streaming}")
    check(len(seen) == rounds, f"{aggregator}: {len(seen)} rounds")
    numbers = [v for r in seen for v in (r["loss"], r["agg_norm"], r["variance"])]
    check(all(map(math.isfinite, numbers)), f"{mode} {aggregator}: non-finite {numbers}")
    return dict(sim=sim, seen=seen, round_s=times, launches=launches, peak=peak)


def warm_round(torch, sim, profiled: bool = False) -> dict:
    """Rounds of ``sim``'s engine from its state (not applied), on a fresh
    sample, after one to warm up: the wall times of 3, the host syncs of
    one, and under torch.profiler one's device busy time (union of kernel
    intervals) and busy share."""
    from torch.profiler import ProfilerActivity, profile

    from blades_tpu_torch.utils import rng

    eng, state = sim.engine, sim.server.state
    cx, cy = sim.dataset.sample_round(rng.generator(sim.seed, 99, rng.DATA, device=eng.device),
                                      1, 32)

    def one():
        return eng.run_round(state, cx, cy, 0.1, 1.0, seed=sim.seed)

    one()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    sites = host_syncs(torch, one)
    out = {"warm_round_ms": walls, "round_host_syncs": sum(sites.values()),
           "round_host_sync_sites": sites}
    if profiled:
        # the first round after the sync-debug window ran about 70 ms slow
        # on an H100: warm again before the profiled one
        one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = device_breakdown(torch, prof, set(), set())
        out.update(profiled_wall_ms=wall, device_busy_ms=dev["busy_ms"],
                   device_busy_share=dev["busy_ms"] / wall,
                   trimmed_mean_kernel_ms=dev["by_class_union_ms"]["trimmed_mean_kernel"],
                   other_top_ms=dev["other_top_ms"][:5])
    return out


def phase_stream_round(torch, trimmed, fl, card: str, log_root: Path) -> tuple:
    """The slice's main path: STREAM_ROUNDS bf16 CCT-2 rounds at K=1000 in 4
    chunks, sign flipping f=5 and trimmed mean b=5, dense and streaming;
    per mode the round times, a profiled warm round (wall, device busy
    share), its host syncs, peak memory and peak_update_bytes. The kernel
    launches once a round in the dense run and never in the streaming run.
    Returns (the dense run's launches, the streaming run's launches)."""
    k, d, b = CCT2_SHAPE
    launches = {}
    for streaming in (False, True):
        mode = "streaming" if streaming else "dense"
        run = stream_run(torch, trimmed, fl, log_root, "trimmedmean", STREAM_ROUNDS, streaming)
        sim = run["sim"]
        eng = sim.engine
        trimmed.trimmed_mean_launches = 0
        warm = warm_round(torch, sim, profiled=True)
        emit({"phase": "stream_round", "mode": mode, "attack": "signflipping",
              "aggregator": "trimmedmean", "dtype": "bfloat16", "clients": k,
              "byzantine": b, "b": b, "rounds": STREAM_ROUNDS,
              "client_chunks": eng.client_chunks, "chunk_size": eng.chunk_size,
              "kernel_launches": run["launches"], "round_s": run["round_s"],
              "train_loss": [r["loss"] for r in run["seen"]],
              "agg_norm": [r["agg_norm"] for r in run["seen"]],
              "peak_mem_bytes": run["peak"], "peak_update_bytes": eng.peak_update_bytes,
              **warm, "card": card})
        want = 0 if streaming else STREAM_ROUNDS
        check(run["launches"] == want, f"{mode}: the kernel launched {run['launches']} times")
        check(eng.peak_update_bytes == (eng.chunk_size if streaming else k) * d * 4,
              f"{mode}: peak_update_bytes {eng.peak_update_bytes}")
        check(streaming or warm["trimmed_mean_kernel_ms"] > 0,
              "dense: the profiled round shows no trimmed-mean kernel")
        check(not streaming or warm["trimmed_mean_kernel_ms"] == 0,
              "streaming: the profiled round shows the trimmed-mean kernel")
        launches[mode] = run["launches"]
        del run, sim, eng
    return launches["dense"], launches["streaming"]


def phase_stream_exact(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """The mean's streaming round against its dense round, one bf16 CCT-2
    round at K=1000 from the same seed: the new params, the loss and the
    aggregate's norm within ROUND_TOL. Returns the streaming launches."""
    from blades_tpu_torch.ops.pytree import ravel

    out = {}
    for streaming in (False, True):
        run = stream_run(torch, trimmed, fl, log_root, "mean", 1, streaming)
        eng = run["sim"].engine
        out[streaming] = (ravel(run["sim"].server.state.params, eng.layout), run["seen"][-1],
                          run["launches"])
        del run, eng
    (p_dense, m_dense, _), (p_stream, m_stream, launches) = out[False], out[True]
    err = float((p_stream - p_dense).abs().max())
    ok = bool(torch.allclose(p_stream, p_dense, **ROUND_TOL))
    emit({"phase": "stream_exact", "aggregator": "mean", "clients": CCT2_SHAPE[0],
          "params_max_abs_err": err, "tol": ROUND_TOL, "ok": ok, "dense": m_dense,
          "streaming": m_stream, "card": card})
    check(ok, f"the mean's streaming and dense rounds differ by {err}")
    for key in ("loss", "agg_norm"):
        check(math.isclose(m_stream[key], m_dense[key], rel_tol=ROUND_TOL["rtol"]),
              f"stream_exact: {key} {m_stream[key]} against {m_dense[key]}")
    return launches


class _Recorder:
    """Keeps the arguments of an aggregator's last streaming_update of a
    chunk ``chunk`` and of its last streaming_finalize (instance
    attributes shadow the class's methods)."""

    def __init__(self, agg, chunk: int = 0):
        self.agg, self.chunk, self.update, self.finalize = agg, chunk, None, None
        update, finalize = agg.streaming_update, agg.streaming_finalize

        def on_update(sstate, slab, *, chunk_mask, chunk_index, **ctx):
            if chunk_index == self.chunk:
                self.update = (slab, chunk_mask, ctx)
            return update(sstate, slab, chunk_mask=chunk_mask, chunk_index=chunk_index, **ctx)

        def on_finalize(sstate, state=(), **ctx):
            self.finalize = (sstate, state, ctx)
            return finalize(sstate, state, **ctx)

        agg.streaming_update, agg.streaming_finalize = on_update, on_finalize

    def remove(self):
        del self.agg.streaming_update, self.agg.streaming_finalize


def phase_stream_aggregators(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """Each streaming defense: STREAM_AGG_ROUNDS bf16 CCT-2 streaming rounds
    at K=1000 (4 chunks of 250) under sign flipping, then one warm round
    (its wall time and its host syncs) recording chunk 0's sanitized slab
    and the finalize's stream state; then streaming_update timed on that
    slab (into a fresh stream state) and streaming_finalize on
    that state, with their host syncs and extra peak memory. Host syncs: a
    round of each defense but GeoMed and AutoGM (whose stopping rules read
    the device) makes as many as the mean's round. Returns the kernel's
    launches per run (0 each)."""
    k, d, f = CCT2_SHAPE
    launches, base_syncs = {}, None
    for aggregator in STREAM_AGGREGATORS:
        run = stream_run(torch, trimmed, fl, log_root, aggregator, STREAM_AGG_ROUNDS, True)
        sim = run["sim"]
        eng, agg = sim.engine, sim.aggregator
        rec = _Recorder(agg)
        warm = warm_round(torch, sim)
        rec.remove()
        (slab, mask, ctx), (sstate, state, fctx) = rec.update, rec.finalize
        c, cs = eng.client_chunks, eng.chunk_size

        fresh = agg.streaming_init(k, c, cs, d, sim.server.state.agg_state, device=eng.device)
        up = call_cost(torch, lambda: agg.streaming_update(fresh, slab, chunk_mask=mask,
                                                           chunk_index=0, **ctx))
        up_iters = getattr(agg, "last_iterations", None)
        fin = call_cost(torch, lambda: agg.streaming_finalize(sstate, state, **fctx))
        emit({"phase": "stream_aggregator", "aggregator": aggregator,
              "kwargs": catalog_kwargs(aggregator), "attack": "signflipping",
              "dtype": "bfloat16", "clients": k, "byzantine": f, "rounds": STREAM_AGG_ROUNDS,
              "client_chunks": c, "chunk_size": cs, "kernel_launches": run["launches"],
              "round_s": run["round_s"], "warm_round_s": run["round_s"][-1],
              "train_loss": [r["loss"] for r in run["seen"]],
              "agg_norm": [r["agg_norm"] for r in run["seen"]],
              "peak_mem_bytes": run["peak"], "participants_chunk0": int(mask.sum()),
              "iterations_timed_update": up_iters,
              "iterations_timed_finalize": getattr(agg, "last_iterations", None),
              **warm, **{f"update_{n}": v for n, v in up.items()},
              **{f"finalize_{n}": v for n, v in fin.items()},
              "own_ms_per_round": up["ms"] * c + fin["ms"], "card": card})
        check(run["launches"] == 0, f"{aggregator}: the kernel launched {run['launches']} times")
        if aggregator == "mean":
            base_syncs = warm["round_host_syncs"]
        elif aggregator not in ("geomed", "autogm"):
            check(warm["round_host_syncs"] == base_syncs,
                  f"{aggregator}: {warm['round_host_syncs']} host syncs a round, the mean's "
                  f"{base_syncs}: {warm['round_host_sync_sites']}")
        launches[f"stream_{aggregator}"] = run["launches"]
        del run, sim, eng, agg, rec, slab, mask, sstate, state, fresh
    return launches


def phase_stream_fault(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """Trimmed mean (b=5) under STREAM_FAULTS (the guard on), 3 bf16 CCT-2
    rounds at K=1000, dense and streaming from the same seed: every
    round's fault counters equal, the guard excluding every corrupt row;
    then the masked trimmed mean timed on one recorded chunk slab of the
    streaming run (the chunk level of its streaming form). Returns the
    streaming run's launches."""
    from blades_tpu_torch.faults import FaultModel
    from blades_tpu_torch.ops.masked import masked_trimmed_mean

    k, d, b = CCT2_SHAPE
    counters, out = {}, {}
    for streaming in (False, True):
        run = stream_run(torch, trimmed, fl, log_root, "trimmedmean", STREAM_ROUNDS, streaming,
                         fault_model=FaultModel(**STREAM_FAULTS))
        counters[streaming] = [r["faults"] for r in run["seen"]]
        out[streaming] = run
        if streaming:
            sim = run["sim"]
            rec = _Recorder(sim.aggregator)
            warm = warm_round(torch, sim)
            rec.remove()
            slab, mask, _ = rec.update
            chunk_b = sim.aggregator._effective_b(slab.shape[0])
            cost = call_cost(torch, lambda: masked_trimmed_mean(slab, mask, chunk_b))
            del rec
        del run
    same = counters[True] == counters[False]
    emit({"phase": "stream_fault", "fault_model": STREAM_FAULTS, "aggregator": "trimmedmean",
          "attack": "signflipping", "dtype": "bfloat16", "clients": k, "b": b,
          "rounds": STREAM_ROUNDS, "faults_by_round": counters[True],
          "dense_faults_by_round": counters[False], "counters_equal": same,
          "round_s": out[True]["round_s"], "dense_round_s": out[False]["round_s"],
          "kernel_launches": out[True]["launches"],
          "dense_kernel_launches": out[False]["launches"],
          "peak_mem_bytes": out[True]["peak"], "dense_peak_mem_bytes": out[False]["peak"],
          **warm, "chunk_slab_shape": list(slab.shape), "chunk_participants": int(mask.sum()),
          "chunk_b": chunk_b, **{f"masked_trimmed_mean_chunk_{n}": v for n, v in cost.items()},
          "card": card})
    check(same, f"stream_fault: counters differ: {counters}")
    for f in counters[True]:
        check(f["excluded_nonfinite"] == f["corrupted"] and f["stale_replayed"] == 0
              and f["participants"] + f["dropped"] + f["excluded_nonfinite"] == k,
              f"stream_fault: {f}")
    check(sum(f["corrupted"] for f in counters[True]) > 0, "stream_fault: nothing corrupted")
    check(out[True]["launches"] == 0 and out[False]["launches"] == 0,
          "stream_fault: the kernel launched under the fault model")
    return out[True]["launches"]


def phase_stream_scale(torch, trimmed, dev, card: str, log_root: Path) -> tuple:
    """The streaming and the dense round at K=STREAM_SCALE_CLIENTS in chunks
    of 250 (CIFAR-shaped store of 50,000 samples, about 12 a client; a
    client's batches wrap around its samples), trimmed mean b=5 and sign
    flipping f=5, STREAM_SCALE_ROUNDS bf16 CCT-2 rounds each: peak memory
    and round times. Returns (dense launches, streaming launches)."""
    from blades_tpu_torch.datasets import Synthetic

    k = STREAM_SCALE_CLIENTS
    fl = Synthetic(num_clients=k, sample_shape=(32, 32, 3), train_bs=32, train_size=50_000,
                   test_size=10_000, cache=False).get_dls(dev)
    launches = {}
    for streaming in (True, False):
        mode = "streaming" if streaming else "dense"
        run = stream_run(torch, trimmed, fl, log_root, "trimmedmean", STREAM_SCALE_ROUNDS,
                         streaming, chunks=STREAM_SCALE_CHUNKS)
        eng = run["sim"].engine
        emit({"phase": "stream_scale", "mode": mode, "clients": k,
              "client_chunks": eng.client_chunks, "chunk_size": eng.chunk_size,
              "min_client_samples": int(fl.train_counts.min()),
              "rounds": STREAM_SCALE_ROUNDS, "round_s": run["round_s"],
              "train_loss": [r["loss"] for r in run["seen"]],
              "kernel_launches": run["launches"], "peak_mem_bytes": run["peak"],
              "peak_update_bytes": eng.peak_update_bytes, "card": card})
        check(run["launches"] == (0 if streaming else STREAM_SCALE_ROUNDS),
              f"stream_scale {mode}: the kernel launched {run['launches']} times")
        launches[mode] = run["launches"]
        del run, eng
    del fl
    return launches["dense"], launches["streaming"]


def phase_stream_card_vs_cpu(torch, x_cpu, mask_cpu, dev) -> None:
    """Each streaming defense's aggregate_streaming on the card and on the
    CPU, on the same [100, 16384] matrix and mask as fault_card_vs_cpu, in
    3 chunks of 34 (the final one padded with 2 rows): TOL, LOOP_TOL for
    GeoMed and AutoGM; the cross-round state too."""
    from blades_tpu_torch.aggregators import get_aggregator

    rows, cols = x_cpu.shape
    sides = {"cpu": (x_cpu, mask_cpu), "cuda": (x_cpu.to(dev), mask_cpu.to(dev))}
    shape = dict(rows=rows, cols=cols, participants=int(mask_cpu.sum()), chunks=3)
    for name in STREAM_AGGREGATORS:
        out, states = {}, {}
        for w, (x, m) in sides.items():
            agg = get_aggregator(name, **catalog_kwargs(name))
            got, states[w] = agg.aggregate_streaming(x, agg.init_state(rows, cols),
                                                     num_chunks=3, mask=m)
            out[w] = got.cpu()
        tol = LOOP_TOL if name in ("geomed", "autogm") else TOL
        _compare(torch, name, out["cuda"], out["cpu"], tol, phase="stream_card_vs_cpu", **shape)
        lt = torch.utils._pytree.tree_leaves
        for i, (a, b) in enumerate(zip(lt(states["cuda"]), lt(states["cpu"]))):
            a = a.cpu()
            if a.dtype.is_floating_point:
                _compare(torch, f"{name}.state{i}", a, b, TOL, phase="stream_card_vs_cpu",
                         **shape)
            else:
                check(torch.equal(a, b), f"{name}: state leaf {i} differs")


def slice_run(torch, trimmed, fl, log_root: Path, name: str, rounds: int,
              aggregator: str = "trimmedmean", attack="alie", register=None, keep_rows=0,
              **run_kw) -> dict:
    """``rounds`` bf16 CCT-2 rounds at K=1000 (4 client chunks) through
    Simulator.run on the store ``fl``: ``attack`` with f=5 (None: no
    uniform attack), ``aggregator`` (trimmed mean b=5), ``register``: the
    attackers of register_attackers, ``run_kw``: more run() arguments; no
    evaluation. Each round's loss, aggregate norm, row count, first
    ``keep_rows`` update rows and, where there are any, its async and
    fault counters and the persistent Adam moments' norms are read in
    on_round_end. Returns the simulator, those records, the round times,
    the kernel's launches and the peak memory."""
    from blades_tpu_torch import Simulator

    gc.collect()
    k, d, f = CCT2_SHAPE
    sim = Simulator(dataset=fl, attack=attack, num_byzantine=f if attack else 0,
                    aggregator=aggregator, aggregator_kws=catalog_kwargs(aggregator), seed=1,
                    log_path=str(log_root / name))
    if register:
        sim.register_attackers(register)
    seen = []

    def on_round_end(rnd, state, m):
        eng = sim.engine
        rec = dict(loss=float(m.train_loss), agg_norm=float(m.agg_norm),
                   rows=int(eng.last_updates.shape[0]),
                   kept=eng.last_updates[:keep_rows].clone())
        if eng.last_async_diag is not None:
            rec["async"] = {n: float(v) if v.is_floating_point() else int(v)
                            for n, v in eng.last_async_diag.items()}
        if eng.last_fault_diag is not None:
            rec["faults"] = {n: int(v) for n, v in eng.last_fault_diag.items()}
        if state.client_opt_state:
            count, mu, nu = state.client_opt_state[-1]
            rec["adam"] = dict(count=[int(count.min()), int(count.max())],
                               mu_norm=float(sum(torch.linalg.vector_norm(t) for t in mu.values())),
                               nu_norm=float(sum(torch.linalg.vector_norm(t) for t in nu.values())))
        seen.append(rec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trimmed.trimmed_mean_launches = 0
    run_kw.setdefault("client_lr", 0.1)
    times = sim.run(model="cct_2_3x2_32", global_rounds=rounds, local_steps=1, server_lr=1.0,
                    validate_interval=rounds + 1, client_chunks=CCT2_CHUNKS,
                    on_round_end=on_round_end, compute_dtype="bfloat16", **run_kw)
    torch.cuda.synchronize()
    launches = trimmed.trimmed_mean_launches
    peak = torch.cuda.max_memory_allocated()
    check(len(seen) == rounds and all(r["rows"] == k for r in seen), f"{name}: rounds {seen}")
    numbers = [v for r in seen for v in (r["loss"], r["agg_norm"])]
    check(all(map(math.isfinite, numbers)), f"{name}: non-finite {numbers}")
    return dict(sim=sim, seen=seen, round_s=times, launches=launches, peak=peak)


def _rel_l2(a, b) -> float:
    return float(((a - b).norm() / b.norm().clamp_min(1e-30)))


def phase_composite_round(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """register_attackers with 2 label flippers, 2 sign flippers and 1 ALIE
    client (f=5), trimmed mean b=5, COMPOSITE_ROUNDS bf16 CCT-2 rounds at
    K=1000, and one round each of an honest run and a uniform
    label-flipping run from the same seed. Each attacker's row is held to
    what its own attack gives: the label flippers' round-1 rows to the
    uniform run's, the sign flippers' to the negation of the honest run's
    (one local step), within a relative L2 error of BF16_ROW_REL (bf16
    training; the label flippers' rows are further than that from the
    honest ones), the honest rows to the honest run's, and the ALIE row to
    ALIE on the round's own matrix. Records the round times, a warm
    round's host syncs and the launches (1 a round). Returns the kernel's
    launches per run."""
    from blades_tpu_torch.attackers import Alie, get_attack
    from blades_tpu_torch.client import ByzantineClient

    k, d, f = CCT2_SHAPE
    attackers = ([ByzantineClient(attack=get_attack("labelflipping", num_classes=10))
                  for _ in range(2)]
                 + [ByzantineClient(attack=get_attack("signflipping")) for _ in range(2)]
                 + [ByzantineClient(attack=Alie(num_clients=k, num_byzantine=f))])
    runs, first = {}, {}
    for name, attack, register, rounds in (("composite", None, attackers, COMPOSITE_ROUNDS),
                                           ("honest", None, None, 1),
                                           ("labelflipping", "labelflipping", None, 1)):
        run = slice_run(torch, trimmed, fl, log_root, f"composite_{name}", rounds,
                        attack=attack, register=register, keep_rows=6)
        first[name] = run["seen"][0]["kept"]
        runs[name] = run
        del run
    comp = runs.pop("composite")
    sim = comp["sim"]
    eng = sim.engine
    u = eng.last_updates
    alie, _ = Alie(num_clients=k, num_byzantine=f).on_updates(u, eng.byz_mask)
    alie_err = float((alie[4] - u[4]).abs().max())
    c, h, lf = first["composite"], first["honest"], first["labelflipping"]
    rows = {"labelflipping": [_rel_l2(c[i], lf[i]) for i in (0, 1)],
            "labelflipping_vs_honest": [_rel_l2(c[i], h[i]) for i in (0, 1)],
            "signflipping_vs_negated_honest": [_rel_l2(c[i], -h[i]) for i in (2, 3)],
            "honest": [_rel_l2(c[5], h[5])]}
    warm = warm_round(torch, sim)
    emit({"phase": "composite_round", "attackers": ["labelflipping"] * 2 + ["signflipping"] * 2
          + ["alie"], "aggregator": "trimmedmean", "dtype": "bfloat16", "clients": k,
          "byzantine": sim.num_byzantine, "b": f, "rounds": COMPOSITE_ROUNDS,
          "kernel_launches": comp["launches"], "round_s": comp["round_s"],
          "train_loss": [r["loss"] for r in comp["seen"]],
          "agg_norm": [r["agg_norm"] for r in comp["seen"]], "peak_mem_bytes": comp["peak"],
          "row_rel_l2": rows, "alie_row_max_abs_err": alie_err, **warm,
          "other_runs_launches": {n: r["launches"] for n, r in runs.items()}, "card": card})
    check(sim.num_byzantine == f and [cl.is_byzantine() for cl in sim.get_clients()[:6]]
          == [True] * 5 + [False], "composite: the byzantine clients")
    check(max(rows["labelflipping"] + rows["signflipping_vs_negated_honest"]
              + rows["honest"]) <= BF16_ROW_REL, f"composite: an attacker's row {rows}")
    check(min(rows["labelflipping_vs_honest"]) > BF16_ROW_REL,
          f"composite: the label flippers' rows are honest ones {rows}")
    check(torch.allclose(alie[4], u[4], **TOL), f"composite: the ALIE row ({alie_err})")
    check(comp["launches"] == COMPOSITE_ROUNDS,
          f"composite: the kernel launched {comp['launches']} times")
    launches = {"cct2_bf16_composite": comp["launches"]}
    launches.update({f"cct2_bf16_composite_{n}": r["launches"] for n, r in runs.items()})
    return launches


def phase_persist_round(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """Adam on the clients (lr PERSIST_CLIENT_LR) with persist=True and with
    persist=False, ALIE f=5 and trimmed mean b=5, PERSIST_ROUNDS bf16 CCT-2
    rounds at K=1000 each: round times and peak memory (the stacked moments
    add 2 x K x D float32); the persistent moments change between rounds
    and stay finite, and every count equals the rounds run. Returns the
    kernel's launches per run."""
    from blades_tpu_torch import ClientOptSpec

    k, d, f = CCT2_SHAPE
    out = {}
    for persist in (True, False):
        name = "persist" if persist else "fresh"
        run = slice_run(torch, trimmed, fl, log_root, f"adam_{name}", PERSIST_ROUNDS,
                        client_optimizer=ClientOptSpec(name="adam", persist=persist),
                        client_lr=PERSIST_CLIENT_LR)
        state = run["sim"].server.state
        moments = [r.get("adam") for r in run["seen"]]
        out[name] = dict(round_s=run["round_s"], peak_mem_bytes=run["peak"],
                         kernel_launches=run["launches"], moments=moments,
                         train_loss=[r["loss"] for r in run["seen"]],
                         state_bytes=sum(t.numel() * t.element_size() for t in
                                         torch.utils._pytree.tree_leaves(state.client_opt_state)))
        del run, state
    emit({"phase": "persist_round", "client_optimizer": "adam", "client_lr": PERSIST_CLIENT_LR,
          "attack": "alie", "aggregator": "trimmedmean", "dtype": "bfloat16", "clients": k,
          "rounds": PERSIST_ROUNDS, **out,
          "peak_extra_bytes": out["persist"]["peak_mem_bytes"] - out["fresh"]["peak_mem_bytes"],
          "card": card})
    moments = out["persist"]["moments"]
    norms = [(m["mu_norm"], m["nu_norm"]) for m in moments]
    check(all(math.isfinite(x) and x > 0 for pair in norms for x in pair),
          f"persist: moments {norms}")
    check(all(a != b for a, b in zip(norms, norms[1:])), f"persist: moments unchanged {norms}")
    check([m["count"] for m in moments] == [[r, r] for r in range(1, PERSIST_ROUNDS + 1)],
          f"persist: counts {moments}")
    check(out["persist"]["state_bytes"] == 2 * k * d * 4 + k * 4 and out["fresh"][
        "state_bytes"] == 0, f"persist: state bytes {out['persist']['state_bytes']}")
    for name in out:
        check(out[name]["kernel_launches"] == PERSIST_ROUNDS, f"{name}: kernel launches")
    return {f"cct2_bf16_adam_{n}": r["kernel_launches"] for n, r in out.items()}


class _MaskedRecorder:
    """Keeps the arguments of an aggregator's last aggregate_masked call (an
    instance attribute shadows the class's method)."""

    def __init__(self, agg):
        self.agg, self.last = agg, None
        masked = agg.aggregate_masked

        def on_call(updates, state=(), *, mask=None, **ctx):
            self.last = (updates, state, mask, ctx)
            return masked(updates, state, mask=mask, **ctx)

        agg.aggregate_masked = on_call

    def remove(self):
        del self.agg.aggregate_masked


def async_run(torch, trimmed, fl, log_root: Path, name: str, ticks: int, config: dict,
              aggregator: str = "trimmedmean", fault_model=None) -> dict:
    """slice_run of ``ticks`` async ticks under ``config`` (ALIE f=5),
    recording the aggregator's last masked call; then a warm tick's wall
    time and host syncs, and the aggregator's own time on the recorded
    weighted buffer and mask (none for the static zero-delay path). Returns
    slice_run's record with ``warm``, ``own`` and ``counters``."""
    from blades_tpu_torch.aggregators import get_aggregator

    agg = get_aggregator(aggregator, **catalog_kwargs(aggregator))
    rec = _MaskedRecorder(agg)
    run = slice_run(torch, trimmed, fl, log_root, name, ticks, aggregator=agg,
                    async_config=config, fault_model=fault_model)
    run["counters"] = [r["async"] for r in run["seen"]]
    run["warm"] = warm_round(torch, run["sim"])
    rec.remove()
    run["own"] = None
    if rec.last is not None:
        updates, state, mask, ctx = rec.last
        run["own"] = call_cost(torch, lambda: agg.aggregate_masked(updates, state, mask=mask,
                                                                    **ctx))
        run["own"]["participants"] = int(mask.sum())
    del rec
    return run


def _check_counters(name: str, counters: list, k: int) -> None:
    for c in counters:
        check(0 <= c["deposited"] <= c["arrivals"] <= k and c["buffer_count"] <= k
              and 0 <= c["stale_excluded"] <= c["buffer_count"]
              and c["aggregated"] == (c["buffer_count"] - c["stale_excluded"]) * c["fired"]
              and c["fired"] in (0, 1), f"{name}: counters {c}")


def phase_async_static(torch, trimmed, fl, card: str, log_root: Path) -> tuple:
    """AsyncConfig(buffer_m=1000) with zero delays, ALIE f=5 and trimmed
    mean b=5, ASYNC_STATIC_ROUNDS bf16 CCT-2 ticks at K=1000, beside the
    sync run from the same seed, both with cuDNN's deterministic
    algorithms: the same unmasked aggregate call a tick, so the params
    equal the sync round's bit for bit, and the kernel launches once a
    tick. Returns (the async launches, the sync run's launches, its peak
    memory)."""
    from blades_tpu_torch.ops.pytree import ravel

    k, d, f = CCT2_SHAPE
    with deterministic_cudnn():
        sync = slice_run(torch, trimmed, fl, log_root, "async_static_sync", ASYNC_STATIC_ROUNDS)
        p_sync = ravel(sync["sim"].server.state.params, sync["sim"].engine.layout)
        asy = slice_run(torch, trimmed, fl, log_root, "async_static", ASYNC_STATIC_ROUNDS,
                        async_config=dict(buffer_m=k))
        p_async = ravel(asy["sim"].server.state.params, asy["sim"].engine.layout)
    same = bool(torch.equal(p_async, p_sync))
    counters = [r["async"] for r in asy["seen"]]
    emit({"phase": "async_static", "async_config": {"buffer_m": k, "arrivals": "zero"},
          "attack": "alie", "aggregator": "trimmedmean", "dtype": "bfloat16", "clients": k,
          "ticks": ASYNC_STATIC_ROUNDS, "kernel_launches": asy["launches"],
          "sync_kernel_launches": sync["launches"], "round_s": asy["round_s"],
          "sync_round_s": sync["round_s"], "peak_mem_bytes": asy["peak"],
          "sync_peak_mem_bytes": sync["peak"], "params_equal_sync": same,
          "params_max_abs_err": float((p_async - p_sync).abs().max()), "counters": counters,
          "card": card})
    check(same, "async_static: the params differ from the sync round's")
    check(asy["launches"] == ASYNC_STATIC_ROUNDS == sync["launches"],
          f"async_static: the kernel launched {asy['launches']} times")
    check(all(c["fired"] == 1 and c["aggregated"] == k and c["max_staleness"] == 0
              for c in counters), f"async_static: counters {counters}")
    return asy["launches"], sync["launches"], sync["peak"]


def phase_async_round(torch, trimmed, fl, card: str, log_root: Path, sync_peak: int) -> int:
    """ASYNC_CONFIG (buffer_m=250, uniform delays up to 2, polynomial
    staleness weights), ALIE f=5 and trimmed mean b=5, ASYNC_TICKS bf16
    CCT-2 ticks at K=1000: per tick the 10 counters and the wall time; a
    warm tick's wall time and host syncs (0: the tick's gates are device
    tensors, and the masked trimmed mean makes none); the peak memory
    beside the sync run's (``sync_peak``); the masked trimmed mean's own
    time on the last fire's weighted buffer. The kernel never launches (the
    general tick takes the masked form). Returns the launches."""
    k, d, f = CCT2_SHAPE
    run = async_run(torch, trimmed, fl, log_root, "async_round", ASYNC_TICKS, ASYNC_CONFIG)
    eng = run["sim"].engine
    emit({"phase": "async_round", "async_config": ASYNC_CONFIG, "attack": "alie",
          "aggregator": "trimmedmean", "dtype": "bfloat16", "clients": k, "ticks": ASYNC_TICKS,
          "buffer_m": eng.async_buffer_m, "kernel_launches": run["launches"],
          "round_s": run["round_s"], "counters": run["counters"],
          "train_loss": [r["loss"] for r in run["seen"]],
          "agg_norm": [r["agg_norm"] for r in run["seen"]], "peak_mem_bytes": run["peak"],
          "sync_peak_mem_bytes": sync_peak, **run["warm"],
          **{f"masked_trimmed_mean_{n}": v for n, v in run["own"].items()}, "card": card})
    _check_counters("async_round", run["counters"], k)
    check(run["launches"] == 0, f"async_round: the kernel launched {run['launches']} times")
    check(run["warm"]["round_host_syncs"] == 0,
          f"async_round: host syncs {run['warm']['round_host_sync_sites']}")
    check(sum(c["fired"] for c in run["counters"]) >= 2 and any(
        c["max_staleness"] > 0 for c in run["counters"]), f"async_round: {run['counters']}")
    return run["launches"]


def phase_async_aggregators(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """``asyncmean`` and ``asynccenteredclipping`` under ASYNC_CONFIG,
    ASYNC_AGG_TICKS ticks each with their own time on the last fire's
    weighted buffer; then each one's streaming form in one
    ``run(streaming=True)`` of ASYNC_STREAM_ROUNDS rounds (sign flipping,
    4 chunks of 250). Returns the kernel's launches per run (0 each)."""
    k, d, f = CCT2_SHAPE
    launches = {}
    for aggregator in ASYNC_AGGREGATORS:
        run = async_run(torch, trimmed, fl, log_root, f"async_{aggregator}", ASYNC_AGG_TICKS,
                        ASYNC_CONFIG, aggregator=aggregator)
        rec = {"phase": "async_aggregator", "aggregator": aggregator,
               "async_config": ASYNC_CONFIG, "attack": "alie", "dtype": "bfloat16",
               "clients": k, "ticks": ASYNC_AGG_TICKS, "kernel_launches": run["launches"],
               "round_s": run["round_s"], "counters": run["counters"],
               "agg_norm": [r["agg_norm"] for r in run["seen"]], "peak_mem_bytes": run["peak"],
               **run["warm"], **{f"aggregate_{n}": v for n, v in run["own"].items()}}
        _check_counters(aggregator, run["counters"], k)
        launches[f"async_{aggregator}"] = run["launches"]
        del run
        stream = stream_run(torch, trimmed, fl, log_root, aggregator, ASYNC_STREAM_ROUNDS, True)
        rec.update(stream_round_s=stream["round_s"], stream_kernel_launches=stream["launches"],
                   stream_peak_mem_bytes=stream["peak"],
                   stream_agg_norm=[r["agg_norm"] for r in stream["seen"]],
                   stream_warm=warm_round(torch, stream["sim"]), card=card)
        emit(rec)
        check(rec["kernel_launches"] == 0 and stream["launches"] == 0,
              f"{aggregator}: the kernel launched")
        check(rec["round_host_syncs"] == 0 and rec["stream_warm"]["round_host_syncs"] == 0,
              f"{aggregator}: host syncs {rec['round_host_sync_sites']}")
        launches[f"stream_{aggregator}"] = stream["launches"]
        del stream
    return launches


def phase_async_fault(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """ASYNC_FAULT_CONFIG (geometric delays of mean 1 up to 3, cutoff 2)
    under FaultModel(ASYNC_FAULTS), ALIE f=5 and trimmed mean b=5,
    ASYNC_FAULT_TICKS bf16 CCT-2 ticks at K=1000: deposited <= arrivals
    (a dropped arrival is lost), 0 <= stale_excluded <= buffer_count, and
    the cutoff excludes the updates more than 2 ticks stale. Returns the
    launches (0)."""
    from blades_tpu_torch.faults import FaultModel

    k, d, f = CCT2_SHAPE
    run = async_run(torch, trimmed, fl, log_root, "async_fault", ASYNC_FAULT_TICKS,
                    ASYNC_FAULT_CONFIG, fault_model=FaultModel(**ASYNC_FAULTS))
    faults = [r["faults"] for r in run["seen"]]
    emit({"phase": "async_fault", "async_config": ASYNC_FAULT_CONFIG,
          "fault_model": ASYNC_FAULTS, "attack": "alie", "aggregator": "trimmedmean",
          "dtype": "bfloat16", "clients": k, "ticks": ASYNC_FAULT_TICKS,
          "kernel_launches": run["launches"], "round_s": run["round_s"],
          "counters": run["counters"], "faults": faults, "peak_mem_bytes": run["peak"],
          **run["warm"], **{f"masked_trimmed_mean_{n}": v for n, v in (run["own"] or {}).items()},
          "card": card})
    _check_counters("async_fault", run["counters"], k)
    check(sum(c["arrivals"] - c["deposited"] for c in run["counters"]) > 0,
          "async_fault: no arrival was dropped")
    check(any(c["stale_excluded"] > 0 for c in run["counters"]) and all(
        c["max_staleness"] <= ASYNC_FAULT_CONFIG["cutoff"] for c in run["counters"]),
        f"async_fault: the cutoff {run['counters']}")
    check(run["launches"] == 0, f"async_fault: the kernel launched {run['launches']} times")
    return run["launches"]


def phase_async_card_vs_cpu(torch, dev) -> None:
    """A K=16 MLP async run, fixed delays (0, 1, 2, ...), buffer_m=7,
    polynomial weights, ALIE f=2 and trimmed mean b=2, ASYNC_CPU_TICKS ticks
    on the card and on the CPU from the same params and batches: the params
    within ROUND_TOL after every tick, the async state's integer fields and
    the counts equal, its float fields within ROUND_TOL. The second tick's 6
    arrivals do not fire it; the first and third fire."""
    from blades_tpu_torch.aggregators import Trimmedmean
    from blades_tpu_torch.asyncfl import AsyncConfig
    from blades_tpu_torch.attackers import Alie
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.models import create_mnist_model
    from blades_tpu_torch.ops.pytree import ravel

    k, f = ASYNC_CPU_CLIENTS, 2
    cfg = AsyncConfig(buffer_m=7, staleness="polynomial",
                      arrivals=dict(kind="fixed", delays=tuple(i % 3 for i in range(k))))
    spec = create_mnist_model()
    params = spec.init(torch.Generator().manual_seed(21))
    ds = Synthetic(num_clients=k, train_bs=32, train_size=4_000, cache=False).get_dls("cpu")
    batches = [ds.sample_round(torch.Generator().manual_seed(22 + t), 1, 32)
               for t in range(ASYNC_CPU_TICKS)]
    out = {}
    for where in ("cpu", dev):
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=k, num_byzantine=f,
                          attack=Alie(num_clients=k, num_byzantine=f),
                          aggregator=Trimmedmean(num_byzantine=f), device=where,
                          async_config=cfg)
        state, ticks = eng.init(params), []
        for cx, cy in batches:
            state, _ = eng.run_round(state, cx.to(where), cy.to(where), 0.1, 1.0, seed=3)
            ticks.append((ravel(state.params, spec.layout).cpu(),
                          {n: t.cpu() for n, t in state.async_state.items()},
                          {n: t.item() for n, t in eng.last_async_diag.items()}))
        out[str(where)] = ticks
    errs, same = [], True
    for (p_cpu, a_cpu, d_cpu), (p_gpu, a_gpu, d_gpu) in zip(out["cpu"], out[str(dev)]):
        errs.append(float((p_gpu - p_cpu).abs().max()))
        same &= torch.allclose(p_gpu, p_cpu, **ROUND_TOL)
        for n, t in a_cpu.items():
            same &= (torch.allclose(a_gpu[n], t, **ROUND_TOL) if t.is_floating_point()
                     else torch.equal(a_gpu[n], t))
        same &= all(d_gpu[n] == v for n, v in d_cpu.items() if isinstance(v, int)) and all(
            math.isclose(d_gpu[n], v, rel_tol=1e-5) for n, v in d_cpu.items()
            if isinstance(v, float))
    emit({"phase": "async_card_vs_cpu", "clients": k, "ticks": ASYNC_CPU_TICKS,
          "async_config": repr(cfg), "tol": ROUND_TOL, "params_max_abs_err": errs,
          "counters_cpu": [t[2] for t in out["cpu"]], "ok": same})
    check(same, f"async_card_vs_cpu: card and CPU differ ({errs})")
    check([t[2]["fired"] for t in out["cpu"]] == [1, 0, 1], "async_card_vs_cpu: the fires")


def _same(torch, a, b) -> bool:
    """Bit-identical tensors, NaN where NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))
    return bool(torch.equal(a, b))


def _tensors(torch, tree) -> list:
    return [t for t in torch.utils._pytree.tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _states_differ(torch, a, b) -> list:
    """The state tensors (by position) that are not bit-identical, and the
    round index if it differs."""
    bad = [] if a.round_idx == b.round_idx else [f"round_idx {a.round_idx} != {b.round_idx}"]
    return bad + [f"state tensor {i}" for i, (x, y) in
                  enumerate(zip(_tensors(torch, a), _tensors(torch, b))) if not _same(torch, x, y)]


def block_equals_rounds(torch, seq, st, st2, ms, diags) -> list:
    """What differs between R sequential rounds (``seq``: each round's
    metrics, fault and async counters; ``st``: their final state) and a
    block (``st2``, its stacked ``ms`` and ``diags``): [] when the block is
    bit-identical (params, every state tensor, round_idx, every metric,
    every counter)."""
    bad = _states_differ(torch, st, st2)
    for i, (m, fdiag, adiag) in enumerate(seq):
        bad += [f"round {i} {n}" for n, x, col in zip(m._fields, m, ms)
                if not _same(torch, x, col[i])]
        for kind, ref in (("faults", fdiag), ("async", adiag)):
            bad += [f"round {i} {kind} {n}" for n in (ref or {})
                    if not _same(torch, ref[n], diags[kind][n][i])]
    return bad


def profiled_block(torch, trimmed, fn) -> dict:
    """A warm block ``fn`` under torch.profiler: its wall (ms), device busy
    time (``device_breakdown``), the trimmed-mean kernel's device events
    and the launches the wrapper counted. The profiler loses some device
    events on the card (it saw 79.4 of a sampler's fixed 80 kernels a
    call, and 2 kernel events of a block's 3 counted launches, on an H100), so
    the block is profiled again, up to PROFILE_ATTEMPTS times, until its
    events equal its counted launches; every attempt's events are kept."""
    from torch.profiler import ProfilerActivity, profile

    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        trimmed.trimmed_mean_launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counted = trimmed.trimmed_mean_launches
        events = sum(1 for e in device_kernels(torch, prof) if "trimmed_mean_kernel" in e.name)
        attempts.append(events)
        if events == counted:
            break
    return dict(wall_ms=wall, dev=device_breakdown(torch, prof, set(), set()), events=events,
                counted=counted, events_by_attempt=attempts)


def engine_blocks(torch, trimmed, fl, log_root: Path, name: str, rounds: int,
                  dtype: str = "bfloat16", aggregator: str = "trimmedmean", attack="alie",
                  warm_block: bool = True, profiled: bool = False, model: str = "cct_2_3x2_32",
                  byzantine: int = MAIN_BYZANTINE, aggregator_kws=None,
                  chunks: int = CCT2_CHUNKS, **run_kw) -> dict:
    """CCT-2 at K=1000 (4 chunks, ``attack`` f=5, ``aggregator``) on the
    store ``fl`` (or ``model`` with ``byzantine`` attackers, the
    aggregator's ``aggregator_kws`` and ``chunks`` client chunks):
    ``rounds`` sequential ``run_round`` calls, then the same
    rounds from the same init as one ``run_block`` (the sampler fused in),
    and with ``warm_block`` a second block from there (a warm graph:
    replays only; under torch.profiler with ``profiled``: its device busy
    share and the kernel's events). Each timed with a device sync, its
    peak memory (allocated, and the allocator's reserve after it: a
    graph's private pool stays reserved between replays) and the kernel's
    launches; the block held to the rounds bit for bit."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.utils import rng

    gc.collect()
    torch.cuda.empty_cache()
    sim = Simulator(dataset=fl, attack=attack, num_byzantine=byzantine if attack else 0,
                    aggregator=aggregator,
                    aggregator_kws=aggregator_kws or catalog_kwargs(aggregator), seed=1,
                    log_path=str(log_root / name))
    sim.run(model=model, global_rounds=0, client_chunks=chunks,
            compute_dtype=None if dtype == "float32" else dtype, **run_kw)
    eng, seed = sim.engine, sim.seed
    p0 = {n: t.clone() for n, t in sim.server.state.params.items()}
    del sim
    lrs, slrs = [0.1] * rounds, [1.0] * rounds

    def measured(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trimmed.trimmed_mean_launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, trimmed.trimmed_mean_launches, \
            (torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved())

    def sequential():
        st, seq, walls = eng.init(p0), [], []
        for i, r in enumerate(range(1, rounds + 1)):
            t0 = time.perf_counter()
            cx, cy = fl.sample_round(rng.generator(seed, r, rng.DATA, device=eng.device), 1, 32)
            st, m = eng.run_round(st, cx, cy, lrs[i], slrs[i], seed)
            del cx, cy
            seq.append((m, eng.last_fault_diag, eng.last_async_diag))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return st, seq, walls

    (st, seq, walls), _, seq_launches, seq_peak = measured(sequential)
    gc.collect()
    torch.cuda.empty_cache()
    sampler = fl.sampler(1, 32)
    (st2, ms, diags), block_s, launches, peak = measured(
        lambda: eng.run_block(eng.init(p0), range(1, rounds + 1), lrs, slrs, seed,
                              sampler=sampler))
    bad = block_equals_rounds(torch, seq, st, st2, ms, diags)
    graph = eng.last_graph if eng.last_block_mode == "graph" else None
    out = dict(engine=eng, mode=eng.last_block_mode, reason=eng.last_block_reason,
               state=st2, seq_state=st, diags=diags, differs=bad, round_s=walls,
               seq_launches=seq_launches,
               seq_peak=seq_peak, block_s=block_s, launches=launches, peak=peak,
               capture_s=graph and graph.capture_seconds,
               warmup_s=graph and graph.warmup_seconds,
               graph_kernel_launches=graph and graph.kernel_launches,
               train_loss=[float(x) for x in ms.train_loss])
    if warm_block:
        def warm():
            return eng.run_block(st2, range(rounds + 1, 2 * rounds + 1), lrs, slrs, seed,
                                 sampler=sampler)

        (st3, _, _), warm_s, warm_launches, warm_peak = measured(warm)
        out.update(warm_block_s=warm_s, warm_block_launches=warm_launches,
                   warm_block_peak=warm_peak, state=st3)
        if profiled:
            prof = profiled_block(torch, trimmed, warm)
            out.update(profiled_block_wall_ms=prof["wall_ms"],
                       profiled_block_busy_ms=prof["dev"]["busy_ms"],
                       profiled_block_busy_share=prof["dev"]["busy_ms"] / prof["wall_ms"],
                       profiled_block_kernel_events=prof["events"],
                       profiled_block_counted_launches=prof["counted"],
                       profiled_block_events_by_attempt=prof["events_by_attempt"])
    return out


def emit_blocks(name: str, run: dict, card: str, **extra) -> dict:
    """One block phase's record (without the engine and the states)."""
    rec = {n: v for n, v in run.items() if n not in ("engine", "state", "seq_state", "diags")}
    rounds = len(run["round_s"])
    rec["round_s_per_block_round"] = run["block_s"] / rounds
    if "warm_block_s" in run:
        rec["warm_block_round_s"] = run["warm_block_s"] / rounds
    emit({"phase": name, **extra, "rounds": rounds, **rec, "card": card})
    return rec


def phase_block_mlp(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """The MLP at K=1000 (ALIE f=5, trimmed mean b=5) through Simulator.run:
    BLOCK_MLP_ROUNDS rounds one by one, then in blocks of BLOCK_MLP_SIZE
    (a captured CUDA graph) with an EngineCache, then again with that cache
    (``engine_cache``: a hit, no capture). Params equal across the three;
    the kernel launches once a round in each. Then a warm block against a
    warm eager round: wall, host syncs (the block's one read of its
    metrics) and, under torch.profiler, device busy share and the kernel's
    events against its counted launches. Returns the launches by path and
    the profiler's kernel events by path."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.sweeps import EngineCache

    k, f = MAIN_CLIENTS, MAIN_BYZANTINE
    run_kw = dict(model="mlp", global_rounds=BLOCK_MLP_ROUNDS, local_steps=1, server_lr=1.0,
                  client_lr=0.1, validate_interval=BLOCK_MLP_ROUNDS)

    def run(name, **kw):
        gc.collect()
        sim = Simulator(dataset=fl, attack="alie", num_byzantine=f, aggregator="trimmedmean",
                        aggregator_kws={"num_byzantine": f}, seed=1, device=fl.device,
                        log_path=str(log_root / name))
        torch.cuda.synchronize()
        trimmed.trimmed_mean_launches = 0
        t0 = time.perf_counter()
        times = sim.run(**run_kw, **kw)
        torch.cuda.synchronize()
        return dict(sim=sim, round_s=times, wall_s=time.perf_counter() - t0,
                    launches=trimmed.trimmed_mean_launches,
                    params=ravel(sim.server.state.params, sim.engine.layout))

    eager = run("block_mlp_eager")
    cache = EngineCache()
    blocked = run("block_mlp_graph", block_size=BLOCK_MLP_SIZE, engine_cache=cache)
    eng = blocked["sim"].engine
    graph = eng.last_graph
    first = dict(replays=graph.replays, capture_s=graph.capture_seconds,
                 warmup_s=graph.warmup_seconds)
    hit = run("engine_cache", block_size=BLOCK_MLP_SIZE, engine_cache=cache)
    hit_replays = graph.replays - first["replays"]
    check(eng.last_block_mode == "graph", f"block_mlp: {eng.last_block_mode} {eng.last_block_reason}")

    # warm: a block of BLOCK_MLP_SIZE rounds and its one read of the metrics,
    # against an eager round
    state, sampler = blocked["sim"].server.state, fl.sampler(1, 32)
    r = BLOCK_MLP_SIZE
    rounds = list(range(BLOCK_MLP_ROUNDS + 1, BLOCK_MLP_ROUNDS + 1 + r))

    def block():
        _, ms, _ = eng.run_block(state, rounds, [0.1] * r, [1.0] * r, 1, sampler=sampler)
        return torch.stack(list(ms)).cpu()

    block()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        block()
        walls.append(time.perf_counter() - t0)
    syncs = host_syncs(torch, block)
    block()
    prof = profiled_block(torch, trimmed, block)
    wall, dev, profiled, counted = prof["wall_ms"], prof["dev"], prof["events"], prof["counted"]
    warm_eager = warm_round(torch, eager["sim"], profiled=True)

    same_graph = bool(torch.equal(blocked["params"], eager["params"]))
    same_hit = bool(torch.equal(hit["params"], blocked["params"]))
    emit({"phase": "block_mlp", "clients": k, "byzantine": f, "b": f,
          "rounds": BLOCK_MLP_ROUNDS, "block_size": BLOCK_MLP_SIZE,
          "mode": eng.last_block_mode, "eager_round_s": eager["round_s"],
          "block_round_s": blocked["round_s"], "eager_wall_s": eager["wall_s"],
          "block_wall_s": blocked["wall_s"], "capture_s": first["capture_s"],
          "warmup_s": first["warmup_s"], "replays": first["replays"],
          "eager_launches": eager["launches"], "block_launches": blocked["launches"],
          "graph_kernel_launches": graph.kernel_launches,
          "params_equal_eager": same_graph,
          "warm_block_ms": [w * 1e3 for w in walls],
          "warm_block_round_ms": [w * 1e3 / r for w in walls],
          "warm_block_host_syncs": sum(syncs.values()), "warm_block_host_sync_sites": syncs,
          "profiled_block_wall_ms": wall, "profiled_block_busy_ms": dev["busy_ms"],
          "profiled_block_busy_share": dev["busy_ms"] / wall,
          "profiled_block_kernel_events": profiled, "profiled_block_counted_launches": counted,
          "profiled_block_events_by_attempt": prof["events_by_attempt"],
          "profiled_block_trimmed_mean_ms": dev["by_class_union_ms"]["trimmed_mean_kernel"],
          "warm_eager_round": warm_eager, "card": card})
    emit({"phase": "engine_cache", "hits": cache.hits, "misses": cache.misses,
          "entries": len(cache), "same_engine": hit["sim"].engine is eng,
          "same_graph": eng.last_graph is graph, "first_wall_s": blocked["wall_s"],
          "hit_wall_s": hit["wall_s"], "hit_round_s": hit["round_s"],
          "replays_in_hit": hit_replays,
          "hit_launches": hit["launches"], "params_equal_fresh": same_hit, "card": card})
    check(same_graph, "block_mlp: the graph blocks' params differ from the rounds'")
    check(eager["launches"] == blocked["launches"] == BLOCK_MLP_ROUNDS,
          f"block_mlp: launches {eager['launches']} / {blocked['launches']}")
    check(graph.kernel_launches == 1 and counted == r,
          f"block_mlp: {graph.kernel_launches} launches captured, {counted} counted")
    check(profiled == counted, f"block_mlp: the profiler saw {profiled} kernels, {counted} counted")
    check(sum(syncs.values()) == 1, f"block_mlp: a warm block synced {syncs}")
    check(cache.hits == 1 and cache.misses == 1 and hit["sim"].engine is eng
          and eng.last_graph is graph and hit_replays == BLOCK_MLP_ROUNDS,
          f"engine_cache: hits {cache.hits}, same graph {eng.last_graph is graph}, "
          f"replays {hit_replays}")
    check(same_hit and hit["launches"] == BLOCK_MLP_ROUNDS,
          f"engine_cache: params equal {same_hit}, launches {hit['launches']}")
    return ({"mlp_k1000_graph_block": blocked["launches"],
             "mlp_k1000_engine_cache": hit["launches"], "mlp_k1000_profiled_block": counted},
            {"mlp_k1000_profiled_block": profiled})


def phase_block_cct2(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """bf16 CCT-2 at K=1000 (ALIE f=5, trimmed mean b=5): BLOCK_CCT2_ROUNDS
    rounds against a graph block of as many, then a warm block; f32:
    BLOCK_F32_ROUNDS. Returns the launches of the blocks and the profiler's
    kernel events in the profiled bf16 block."""
    launches, events = {}, {}
    for dtype, rounds in (("bfloat16", BLOCK_CCT2_ROUNDS), ("float32", BLOCK_F32_ROUNDS)):
        run = engine_blocks(torch, trimmed, fl, log_root, f"block_cct2_{dtype}", rounds, dtype,
                            profiled=dtype == "bfloat16")
        emit_blocks("block_cct2", run, card, dtype=dtype, attack="alie",
                    aggregator="trimmedmean", clients=CCT2_SHAPE[0])
        check(run["mode"] == "graph", f"block_cct2 {dtype}: {run['mode']} {run['reason']}")
        check(not run["differs"], f"block_cct2 {dtype}: the block differs: {run['differs']}")
        check(run["seq_launches"] == run["launches"] == run["warm_block_launches"] == rounds,
              f"block_cct2 {dtype}: launches {run['seq_launches']} / {run['launches']}")
        check(run.get("profiled_block_kernel_events") == run.get(
            "profiled_block_counted_launches", rounds) == rounds or dtype != "bfloat16",
            f"block_cct2 {dtype}: the profiler saw {run.get('profiled_block_kernel_events')} "
            f"kernels, {run.get('profiled_block_counted_launches')} counted")
        launches[f"cct2_{dtype}_graph_block"] = run["launches"] + run["warm_block_launches"]
        if "profiled_block_kernel_events" in run:
            events[f"cct2_{dtype}_profiled_block"] = run["profiled_block_kernel_events"]
            launches[f"cct2_{dtype}_profiled_block"] = run["profiled_block_counted_launches"]
        del run
    return launches, events


def phase_block_fault_async(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """Graph blocks of BLOCK_SLICE_ROUNDS bf16 CCT-2 rounds under the fault
    model of fault_round (trimmed mean's masked form) and of as many async
    ticks under ASYNC_CONFIG, each held to the same rounds run one by one,
    counters included. The kernel launches in neither."""
    from blades_tpu_torch.faults import FaultModel

    launches = {}
    for name, kw in (("faults", dict(fault_model=FaultModel(**FAULTS))),
                     ("async", dict(async_config=ASYNC_CONFIG))):
        run = engine_blocks(torch, trimmed, fl, log_root, f"block_{name}", BLOCK_SLICE_ROUNDS,
                            **kw)
        counters = {n: v.tolist() for n, v in (run["diags"][name] or {}).items()}
        emit_blocks("block_fault_async", run, card, kind=name, counters=counters,
                    clients=CCT2_SHAPE[0])
        check(run["mode"] == "graph", f"block_{name}: {run['mode']} {run['reason']}")
        check(not run["differs"], f"block_{name}: the block differs: {run['differs']}")
        check(run["launches"] == run["seq_launches"] == 0,
              f"block_{name}: the kernel launched {run['launches']} times")
        launches[name] = run["launches"] + run["warm_block_launches"]
        del run
    return launches


def phase_block_linkage(torch, trimmed, fl, card: str, log_root: Path) -> None:
    """A graph block of BLOCK_LINKAGE_ROUNDS bf16 CCT-2 rounds with clipped
    clustering under ALIE, held to the rounds; then the defense's own time
    on a round's update matrix, eager and as a replayed graph of the call
    alone, the two results equal."""
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.utils import rng

    run = engine_blocks(torch, trimmed, fl, log_root, "block_linkage", BLOCK_LINKAGE_ROUNDS,
                        aggregator="clippedclustering")
    eng, state = run["engine"], run["state"]
    eng.keep_updates = True
    cx, cy = fl.sample_round(rng.generator(1, 50, rng.DATA, device=eng.device), 1, 32)
    eng.run_round(state, cx, cy, 0.1, 1.0, 1)
    updates, agg = eng.last_updates, eng.aggregator
    eng.keep_updates, eng.last_updates = False, None
    del cx, cy
    ctx = dict(trusted_mask=eng.trusted_mask, params_flat=ravel(state.params, eng.layout))
    eager_out = agg.aggregate(updates, state.agg_state, **ctx)[0]
    eager = call_cost(torch, lambda: agg.aggregate(updates, state.agg_state, **ctx))
    side, main = torch.cuda.Stream(), torch.cuda.current_stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        agg.aggregate(updates, state.agg_state, **ctx)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, stream=side):
        graph_out = agg.aggregate(updates, state.agg_state, **ctx)[0]
    capture_s = time.perf_counter() - t0
    graph_ms = time_ms(graph.replay, reps=10)
    same = bool(torch.equal(graph_out, eager_out))
    emit_blocks("block_linkage", run, card, aggregator="clippedclustering", attack="alie",
                clients=CCT2_SHAPE[0], own_eager_ms=eager["ms"],
                own_eager_host_syncs=eager["host_syncs"], own_graph_ms=graph_ms,
                own_graph_capture_s=capture_s, own_graph_equal=same)
    check(run["mode"] == "graph", f"block_linkage: {run['mode']} {run['reason']}")
    check(not run["differs"], f"block_linkage: the block differs: {run['differs']}")
    check(same, "block_linkage: the replayed defense differs from the eager call")
    del graph, run, eng, state, updates


def phase_block_eager(torch, trimmed, fl, card: str, log_root: Path) -> None:
    """Blocks that run eagerly, each with its reason: BLOCK_EAGER_ROUNDS bf16
    CCT-2 rounds with GeoMed (a host-side stopping rule) and as many
    streaming rounds (sign flipping, trimmed mean), each held to the rounds
    run one by one."""
    for name, kw in (("geomed", dict(aggregator="geomed")),
                     ("streaming", dict(attack="signflipping", streaming=True))):
        run = engine_blocks(torch, trimmed, fl, log_root, f"block_eager_{name}",
                            BLOCK_EAGER_ROUNDS, warm_block=False, **kw)
        emit_blocks("block_eager", run, card, kind=name, clients=CCT2_SHAPE[0])
        check(run["mode"] == "eager" and run["reason"], f"block_eager {name}: {run['mode']}")
        check(not run["differs"], f"block_eager {name}: the block differs: {run['differs']}")
        del run


def phase_experiments(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """ExperimentBatch of EXPERIMENTS at the MLP K=1000 round: one round of
    each on one shared batch (one replay each of a graph on the static
    batch) and a block of 2 rounds each (the sampler's graph), each column
    held to that experiment's own run_round / run_block. Returns the
    launches."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.core import ExperimentBatch, unstack_experiments
    from blades_tpu_torch.utils import rng

    gc.collect()
    sim = Simulator(dataset=fl, attack="alie", num_byzantine=MAIN_BYZANTINE,
                    aggregator="trimmedmean", aggregator_kws={"num_byzantine": MAIN_BYZANTINE},
                    seed=1, device=fl.device, log_path=str(log_root / "experiments"))
    sim.run(model="mlp", global_rounds=0)
    eng = sim.engine
    p0 = {n: t.clone() for n, t in sim.server.state.params.items()}
    s = EXPERIMENTS
    eb = ExperimentBatch(eng, s)
    cx, cy = fl.sample_round(rng.generator(1, 201, rng.DATA, device=eng.device), 1, 32)
    c_lrs, s_lrs, seeds = [0.1, 0.05], [1.0, 0.5], [1, 2]
    torch.cuda.synchronize()
    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    states, ms, _ = eb.run_round_batch(eb.init_batch(p0), cx, cy, c_lrs, s_lrs, seeds)
    torch.cuda.synchronize()
    round_s, round_mode = time.perf_counter() - t0, eng.last_block_mode
    launches = trimmed.trimmed_mean_launches
    differs = []
    for i, got in enumerate(unstack_experiments(states)):
        ref, m = eng.run_round(eng.init(p0), cx, cy, c_lrs[i], s_lrs[i], seeds[i])
        differs += [f"round {i}: {d}" for d in block_equals_rounds(
            torch, [(m, None, None)], ref, got, [col[i:i + 1] for col in ms], {})]
    rounds = [[301, 401], [302, 402]]
    lrs = [[0.1, 0.05], [0.1, 0.05]]
    slrs = [[1.0, 0.5], [1.0, 0.5]]
    sampler = fl.sampler(1, 32)
    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    states, ms, _ = eb.run_block_batch(eb.init_batch(p0), rounds, lrs, slrs, seeds,
                                       sampler=sampler)
    torch.cuda.synchronize()
    block_s, block_mode = time.perf_counter() - t0, eng.last_block_mode
    launches += trimmed.trimmed_mean_launches
    for i, got in enumerate(unstack_experiments(states)):
        col = lambda t: [row[i] for row in t]  # noqa: E731
        ref, m, _ = eng.run_block(eng.init(p0), col(rounds), col(lrs), col(slrs), seeds[i],
                                  sampler=sampler)
        if not (all(_same(torch, a, b[:, i]) for a, b in zip(m, ms))
                and not block_equals_rounds(torch, [], ref, got, ms, {})):
            differs.append(f"block column {i}")
    emit({"phase": "experiments", "experiments": s, "clients": MAIN_CLIENTS,
          "round_mode": round_mode, "round_batch_s": round_s, "block_mode": block_mode,
          "block_batch_s": block_s, "block_rounds": len(rounds), "kernel_launches": launches,
          "graph_replays": eng.last_graph.replays, "differs": differs, "card": card})
    check(round_mode == block_mode == "graph", f"experiments: {round_mode} / {block_mode}")
    check(not differs, f"experiments: columns differ: {differs}")
    check(launches == s * (1 + len(rounds)), f"experiments: {launches} launches")
    return launches


def phase_donate(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """DONATE_ROUNDS bf16 CCT-2 rounds at K=1000 (ALIE, trimmed mean) on one
    engine, twice from one state: through run_round, with the caller holding
    the batch, and through run_round_donated, which empties the batch list
    once local training has consumed it (what Simulator.run does every
    round): the peak memory of each, the params equal. Returns the
    launches of the donated rounds."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.utils import rng

    k, d, f = CCT2_SHAPE
    gc.collect()
    torch.cuda.empty_cache()
    sim = Simulator(dataset=fl, attack="alie", num_byzantine=f, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": f}, seed=1,
                    device=fl.device, log_path=str(log_root / "donate"))
    sim.run(model="cct_2_3x2_32", global_rounds=0, client_chunks=CCT2_CHUNKS,
            compute_dtype="bfloat16")
    eng, state0 = sim.engine, sim.server.state
    out = {}
    for donate in (False, True):
        state, times, peaks = state0, [], []
        trimmed.trimmed_mean_launches = 0
        for rnd in range(1, DONATE_ROUNDS + 1):
            batch = list(fl.sample_round(rng.generator(1, rnd, rng.DATA, device=eng.device),
                                         1, 32))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if donate:
                state, _ = eng.run_round_donated(state, batch, 0.1, 1.0, 1)
            else:
                state, _ = eng.run_round(state, *batch, 0.1, 1.0, 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            del batch
        out[donate] = dict(round_s=times, peaks=peaks, launches=trimmed.trimmed_mean_launches,
                           params=ravel(state.params, eng.layout))
    same = bool(torch.equal(out[True]["params"], out[False]["params"]))
    emit({"phase": "donate", "dtype": "bfloat16", "clients": k, "rounds": DONATE_ROUNDS,
          "round_s": out[False]["round_s"], "donate_round_s": out[True]["round_s"],
          "peak_mem_bytes": out[False]["peaks"], "donate_peak_mem_bytes": out[True]["peaks"],
          "params_equal": same, "card": card})
    check(same, "donate: the params differ between held and donated batches")
    check(out[True]["launches"] == out[False]["launches"] == DONATE_ROUNDS,
          f"donate: launches {out[True]['launches']}")
    return out[True]["launches"]


def forensics_sim(fl, log_root: Path, name: str, attack: str = "alie",
                  aggregator: str = "trimmedmean"):
    """A Simulator of the forensics phases on the store ``fl``: ``attack``
    f=5 and ``aggregator`` (trimmed mean b=5), seed 1."""
    from blades_tpu_torch import Simulator

    f = CCT2_SHAPE[2]
    return Simulator(dataset=fl, attack=attack, num_byzantine=f, aggregator=aggregator,
                     aggregator_kws={"num_byzantine": f}, seed=1, device=fl.device,
                     log_path=str(log_root / name))


def forensics_options(fallback: str = "trimmedmean") -> dict:
    """The three forensics options of ``Simulator.run``."""
    from blades_tpu_torch.audit import AuditMonitor

    return dict(collect_diagnostics=True, round_metrics=True,
                audit_monitor=AuditMonitor(fallback_aggregator=fallback))


def forensics_records(log_dir: Path) -> dict:
    """The trace of a run: its schema errors, and its records by type
    (the run's identity fields dropped, so two runs' records compare)."""
    from blades_tpu_torch.telemetry import schema

    path = str(log_dir / "telemetry.jsonl")
    by_type = {}
    for r in schema.load_trace(path):
        r = {n: v for n, v in r.items() if n not in ("run_id", "attempt")}
        by_type.setdefault(r["t"], []).append(r)
    return {"errors": schema.validate_trace(path), "by_type": by_type}


def round_peak(torch, sim) -> tuple:
    """One warm round of ``sim``'s engine from its state (not applied): its
    wall (ms) and the peak memory it allocated above what was allocated
    before it."""
    from blades_tpu_torch.utils import rng

    eng, state = sim.engine, sim.server.state
    cx, cy = sim.dataset.sample_round(rng.generator(sim.seed, 98, rng.DATA, device=eng.device),
                                      1, 32)
    eng.run_round(state, cx, cy, 0.1, 1.0, seed=sim.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng.run_round(state, cx, cy, 0.1, 1.0, seed=sim.seed)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() - base


def _compare_fields(torch, name: str, got: dict, ref: dict) -> list:
    """The fields of two forensic dicts (numpy or tensors) that differ:
    integers and flags exactly, floats at TOL."""
    import numpy as np

    bad = []
    for n in sorted(set(got) | set(ref)):
        if n not in got or n not in ref:
            bad.append(f"{name}.{n} missing")
            continue
        a = np.asarray(got[n].cpu() if isinstance(got[n], torch.Tensor) else got[n])
        b = np.asarray(ref[n].cpu() if isinstance(ref[n], torch.Tensor) else ref[n])
        ok = (np.array_equal(a, b) if a.dtype.kind in "biu"
              else np.allclose(a, b, rtol=TOL["rtol"], atol=TOL["atol"]))
        if not ok:
            bad.append(f"{name}.{n}: card {a.tolist() if a.size < 8 else a[:4].tolist()} "
                       f"cpu {b.tolist() if b.size < 8 else b[:4].tolist()}")
    return bad


def phase_forensics_round(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """The slice's main path: bf16 CCT-2 at K=1000 in 4 chunks, ALIE f=5,
    trimmed mean b=5, through Simulator.run with collect_diagnostics,
    round_metrics and AuditMonitor(fallback_aggregator="trimmedmean"), with
    cuDNN deterministic. FORENSICS_ROUNDS eager rounds, then the same rounds
    as a graph block: the kernel launches twice a round (the defense and the
    audit's fallback), the block's defense, audit and metrics records equal
    the eager rounds' bit for bit, both traces validate with one round,
    defense, audit and metrics record a round, trim counts summing to 2bD.
    A warm graph block: its host syncs (one read of metrics and forensics)
    and its kernel events under the profiler against its counted launches.
    The last eager round's [K, D] matrix is copied to the CPU, where the trim
    counts, the audit and the metric pack are computed again and compared.
    Costs: the warm round with the options on and off, the own time, host
    syncs and extra peak memory of the trim-count diagnostics, the audit's
    apply (its fallback kernel launch included) and pack_dense. Returns the
    launches by path and the profiled block's kernel events."""
    from blades_tpu_torch.aggregators import Trimmedmean
    from blades_tpu_torch.audit import AuditMonitor
    from blades_tpu_torch.core.engine import BLOCK_DIAGS, outputs_to_host
    from blades_tpu_torch.telemetry.metric_pack import pack_dense

    k, d, b = CCT2_SHAPE
    r = FORENSICS_ROUNDS
    run = dict(model="cct_2_3x2_32", global_rounds=r, local_steps=1, server_lr=1.0,
               client_lr=0.1, validate_interval=r + 1, client_chunks=CCT2_CHUNKS,
               compute_dtype="bfloat16")
    launches, out = {}, {}

    # eager rounds, each round's forensics read where the Simulator logs them
    gc.collect()
    torch.cuda.empty_cache()
    sim = forensics_sim(fl, log_root, "forensics_eager")
    seen, kept = [], {}

    def on_round_end(rnd, state, m):
        eng = sim.engine
        seen.append((eng.last_diagnostics, eng.last_audit_diag, eng.last_metric_pack))
        if rnd == r:
            kept["updates"] = eng.last_updates.cpu()

    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    profile_dir = log_root / "forensics_profile"
    eager_s = sim.run(**run, **forensics_options(), on_round_end=on_round_end,
                      profile_dir=str(profile_dir))
    torch.cuda.synchronize()
    out["eager_wall_s"] = time.perf_counter() - t0
    launches["cct2_bf16_forensics_eager"] = trimmed.trimmed_mean_launches
    diag, audit, pack = seen[-1]
    u_dev, byz = sim.engine.last_updates, sim.engine.byz_mask
    eager_trace = forensics_records(log_root / "forensics_eager")
    # the profiler's capture of the run's last round: recorded ok, exported
    trace_file = profile_dir / "trace.json"
    profiled = [(x["action"], x["ok"]) for x in eager_trace["by_type"].get("profile", [])]
    out["profile_records"] = profiled
    out["profile_trace_bytes"] = trace_file.stat().st_size if trace_file.exists() else 0

    # costs on the card, on the last round's matrix
    tm, mon = Trimmedmean(b), AuditMonitor(fallback_aggregator="trimmedmean")
    # the kernel's aggregate: the round's own (no certificate breached)
    agg_dev, _ = tm.aggregate(u_dev)
    kept["agg"] = agg_dev.cpu()
    ones = torch.ones(k, dtype=torch.bool, device=u_dev.device)
    costs = {
        "trim_count_diagnostics": call_cost(torch, lambda: tm.diagnostics(u_dev)),
        "audit_apply": call_cost(torch, lambda: mon.apply(u_dev, agg_dev, byz_mask=byz)),
        "pack_dense": call_cost(torch, lambda: pack_dense(u_dev, ones, byz, agg_dev,
                                                          CCT2_CHUNKS, k // CCT2_CHUNKS)),
    }
    on_warm = warm_round(torch, sim)
    on_ms, on_peak = round_peak(torch, sim)
    breached = any(int(x["breach"]) for x in eager_trace["by_type"].get("audit", []))
    del sim, u_dev, agg_dev, seen, ones

    # the same round with the options off
    gc.collect()
    torch.cuda.empty_cache()
    off = forensics_sim(fl, log_root, "forensics_off")
    off.run(**dict(run, global_rounds=1), on_round_end=lambda *a: None)
    off_warm = warm_round(torch, off)
    off_ms, off_peak = round_peak(torch, off)
    del off

    # the same rounds as a graph block, then a warm block
    gc.collect()
    torch.cuda.empty_cache()
    blk = forensics_sim(fl, log_root, "forensics_block")
    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    blk.run(**run, **forensics_options(), block_size=r)
    torch.cuda.synchronize()
    out["block_wall_s"] = time.perf_counter() - t0
    launches["cct2_bf16_forensics_graph_block"] = trimmed.trimmed_mean_launches
    eng = blk.engine
    check(eng.last_block_mode == "graph",
          f"forensics: the block ran {eng.last_block_mode} ({eng.last_block_reason})")
    block_trace = forensics_records(log_root / "forensics_block")
    state, sampler = blk.server.state, fl.sampler(1, 32)
    rounds = list(range(r + 1, 2 * r + 1))

    def block():
        _, ms, diags = eng.run_block(state, rounds, [0.1] * r, [1.0] * r, blk.seed,
                                     sampler=sampler)
        return outputs_to_host((ms,) + tuple(diags[n] for n in BLOCK_DIAGS))

    block()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        block()
        walls.append((time.perf_counter() - t0) * 1e3)
    syncs = host_syncs(torch, block)
    prof = profiled_block(torch, trimmed, block)
    graph_launches = eng.last_graph.kernel_launches
    del blk, eng, state

    # the card's forensics against the CPU's, on the same [K, D] matrix and
    # the same aggregate (the kernel's; the kernel against its plain version
    # is the kernel phases' check)
    t0 = time.perf_counter()
    u_cpu, agg_card = kept.pop("updates"), kept.pop("agg")
    byz_cpu = byz.cpu()
    tm_cpu = Trimmedmean(b)
    cpu_diag = tm_cpu.diagnostics(u_cpu)
    cpu_final, cpu_audit = AuditMonitor(fallback_aggregator="trimmedmean").apply(
        u_cpu, agg_card, byz_mask=byz_cpu)
    cpu_pack = pack_dense(u_cpu, torch.ones(k, dtype=torch.bool), byz_cpu, cpu_final,
                          CCT2_CHUNKS, k // CCT2_CHUNKS)
    cpu_s = time.perf_counter() - t0
    del u_cpu
    card_vs_cpu = (_compare_fields(torch, "defense", diag, cpu_diag)
                   + _compare_fields(torch, "audit", audit, cpu_audit)
                   + _compare_fields(torch, "metrics", pack._asdict(), cpu_pack._asdict()))

    # the traces
    kinds = ("round", "defense", "audit", "metrics")
    counts = {t: [len(tr["by_type"].get(t, [])) for tr in (eager_trace, block_trace)]
              for t in kinds}
    defense = eager_trace["by_type"].get("defense", [])
    same_records = {t: eager_trace["by_type"].get(t) == block_trace["by_type"].get(t)
                    for t in ("defense", "audit", "metrics")}
    differing = [(t, n, a[n], b_[n]) for t in same_records if not same_records[t]
                 for a, b_ in zip(eager_trace["by_type"].get(t, []),
                                  block_trace["by_type"].get(t, []))
                 for n in a if a[n] != b_.get(n)][:6]
    per_round = r * 2
    emit({"phase": "forensics_round", "dtype": "bfloat16", "clients": k, "byzantine": b,
          "b": b, "rounds": r, "client_chunks": CCT2_CHUNKS,
          "fallback_aggregator": "trimmedmean", "eager_round_s": eager_s,
          "launches": launches, "graph_kernel_launches": graph_launches,
          "trace_errors": eager_trace["errors"][:5] + block_trace["errors"][:5],
          "record_counts_eager_block": counts, "block_records_equal_eager": same_records,
          "block_records_differing": differing,
          "trim_counts_sum": [sum(x["trim_counts"]) for x in defense],
          "byz_trim_frac": [x["byz_trim_frac"] for x in defense],
          "audit": [{n: x[n] for n in ("breach", "fallback_used", "cert_median_ball",
                                        "cert_envelope", "dev_honest", "max_honest_dev")}
                    for x in eager_trace["by_type"].get("audit", [])],
          "metrics_cos": [(x["cos_honest"], x["cos_byz"])
                          for x in eager_trace["by_type"].get("metrics", [])],
          "card_vs_cpu_differs": card_vs_cpu, "cpu_check_s": cpu_s,
          "breached": breached,
          "warm_round_ms_on": on_warm["warm_round_ms"],
          "warm_round_ms_off": off_warm["warm_round_ms"],
          "round_host_syncs_on": on_warm["round_host_syncs"],
          "round_host_syncs_off": off_warm["round_host_syncs"],
          "peak_round_ms_on_off": [on_ms, off_ms],
          "round_peak_extra_bytes_on_off": [on_peak, off_peak],
          "forensics_extra_peak_bytes": on_peak - off_peak,
          "costs": costs, "warm_block_ms": walls, "warm_block_round_ms": [w / r for w in walls],
          "warm_block_host_syncs": sum(syncs.values()), "warm_block_host_sync_sites": syncs,
          "profiled_block_kernel_events": prof["events"],
          "profiled_block_counted_launches": prof["counted"],
          "profiled_block_events_by_attempt": prof["events_by_attempt"],
          "profiled_block_busy_share": prof["dev"]["busy_ms"] / prof["wall_ms"],
          **out, "card": card})
    check(profiled == [("start", True), ("stop", True)] and out["profile_trace_bytes"] > 0,
          f"forensics: profile_dir capture {profiled}, {out['profile_trace_bytes']} bytes")
    check(not eager_trace["errors"] and not block_trace["errors"],
          f"forensics: trace errors {eager_trace['errors'][:3]} {block_trace['errors'][:3]}")
    check(all(c == [r, r] for c in counts.values()), f"forensics: record counts {counts}")
    check(all(same_records.values()), f"forensics: block records differ {same_records}")
    check(launches["cct2_bf16_forensics_eager"] == per_round
          and launches["cct2_bf16_forensics_graph_block"] == per_round
          and graph_launches == 2 and prof["counted"] == per_round,
          f"forensics: launches {launches}, captured {graph_launches}, "
          f"block {prof['counted']} (2 a round)")
    check(prof["events"] == prof["counted"],
          f"forensics: the profiler saw {prof['events']} kernels, {prof['counted']} counted")
    check(sum(syncs.values()) == 1, f"forensics: a warm block synced {syncs}")
    check(all(x == 2 * b * d for x in (sum(y["trim_counts"]) for y in defense)),
          "forensics: trim counts do not sum to 2bD")
    check(all(0.0 <= x["byz_trim_frac"] <= 1.0 for x in defense), "forensics: byz_trim_frac")
    check(not card_vs_cpu, f"forensics: card and CPU differ: {card_vs_cpu[:5]}")
    check(not breached, "forensics: a round breached, so its aggregate is not the kernel's")
    check(all(c["host_syncs"] == 0 for c in costs.values()),
          f"forensics: host syncs {[(n, c['host_syncs']) for n, c in costs.items()]}")
    launches["cct2_bf16_forensics_profiled_block"] = prof["counted"]
    return launches, {"cct2_bf16_forensics_profiled_block": prof["events"]}


def phase_stream_forensics(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """One streaming bf16 CCT-2 round at K=1000 in 4 chunks (sign flipping
    f=5, trimmed mean b=5) with round_metrics and an AuditMonitor whose
    fallback has a streaming form (median), beside the dense round of the
    same rows: the pack's elementwise fields (norms, histogram, extremes,
    counts) equal (the cosines are reported: the streaming trimmed mean is
    two-level, another aggregate), the streaming audit's interval fields
    present, both traces valid; collect_diagnostics under
    streaming=True raises. Returns the launches of each run (the dense
    round's defense is the kernel, its median fallback is not; the
    streaming round never launches it)."""
    elementwise = ("norm_q", "norm_hist", "n_participants", "n_masked_out", "slab_absmax",
                   "slab_norm_max")
    run = dict(model="cct_2_3x2_32", global_rounds=1, local_steps=1, server_lr=1.0,
               client_lr=0.1, validate_interval=2, client_chunks=CCT2_CHUNKS,
               compute_dtype="bfloat16")
    packs, audits, launches, traces = {}, {}, {}, {}
    for streaming in (False, True):
        mode = "stream" if streaming else "dense"
        gc.collect()
        torch.cuda.empty_cache()
        sim = forensics_sim(fl, log_root, f"forensics_{mode}", attack="signflipping")
        opts = forensics_options("median")
        del opts["collect_diagnostics"]
        trimmed.trimmed_mean_launches = 0
        sim.run(**run, **opts, streaming=streaming)
        torch.cuda.synchronize()
        launches[mode] = trimmed.trimmed_mean_launches
        packs[mode] = sim.engine.last_metric_pack
        audits[mode] = sim.engine.last_audit_diag
        traces[mode] = forensics_records(log_root / f"forensics_{mode}")
        if streaming:
            refused = None
            try:
                sim.run(**run, streaming=True, collect_diagnostics=True)
            except ValueError as err:
                refused = str(err)
        del sim
    same = {n: bool(torch.equal(getattr(packs["stream"], n), getattr(packs["dense"], n)))
            for n in elementwise}
    cos = {n: [float(getattr(packs[m], n)) for m in ("dense", "stream")]
           for n in ("cos_honest", "cos_byz")}
    emit({"phase": "stream_forensics", "clients": CCT2_SHAPE[0], "attack": "signflipping",
          "aggregator": "trimmedmean", "fallback_aggregator": "median",
          "elementwise_equal": same, "cos_dense_stream": cos, "launches": launches,
          "stream_audit": {n: float(v) for n, v in audits["stream"].items()},
          "trace_errors": traces["dense"]["errors"][:3] + traces["stream"]["errors"][:3],
          "collect_diagnostics_refused": refused, "card": card})
    check(all(same.values()), f"stream_forensics: elementwise fields differ {same}")
    check("spread_median_lo" in audits["stream"] and "dev_honest" in audits["dense"],
          f"stream_forensics: audit fields {sorted(audits['stream'])}")
    check(not traces["dense"]["errors"] and not traces["stream"]["errors"],
          "stream_forensics: trace errors")
    check(refused is not None and "collect_diagnostics" in refused,
          f"stream_forensics: collect_diagnostics under streaming gave {refused!r}")
    check(launches == {"dense": 1, "stream": 0}, f"stream_forensics: launches {launches}")
    return launches


def write_cifar10(root: Path, seed: int = 0) -> Path:
    """CIFAR-10's python-pickle layout at its published size under
    ``root``: ``cifar-10-batches-py/data_batch_1..5`` (10,000 images each)
    and ``test_batch`` (10,000), seeded uint8 pixels and labels."""
    import pickle

    import numpy as np

    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    r = np.random.RandomState(seed)
    files = [(f"data_batch_{i}", CIFAR10_TRAIN // 5) for i in range(1, 6)]
    for name, n in files + [("test_batch", CIFAR10_TEST)]:
        with open(d / name, "wb") as fh:
            pickle.dump({b"data": r.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": r.randint(0, 10, n).tolist()}, fh)
    return d


def write_mnist(root: Path, seed: int = 0) -> None:
    """MNIST's four gzipped IDX files at its published size (60,000 /
    10,000) under ``root``, seeded uint8 pixels and labels."""
    import gzip
    import struct

    import numpy as np

    root.mkdir(parents=True)
    r = np.random.RandomState(seed)
    for prefix, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST)):
        with gzip.open(root / f"{prefix}-images-idx3-ubyte.gz", "wb", compresslevel=1) as fh:
            fh.write(struct.pack(">IIII", 2051, n, 28, 28))
            fh.write(r.randint(0, 256, (n, 28, 28), dtype=np.uint8).tobytes())
        with gzip.open(root / f"{prefix}-labels-idx1-ubyte.gz", "wb", compresslevel=1) as fh:
            fh.write(struct.pack(">II", 2049, n))
            fh.write(r.randint(0, 10, n).astype(np.uint8).tobytes())


def _records(log_dir: Path, kind: str) -> list:
    from blades_tpu_torch.utils.logging import read_stats

    return [{n: v for n, v in r.items() if n != "_meta"} for r in read_stats(str(log_dir), kind)]


def data_simulator(ds, log_root: Path, name: str, **kw):
    """The main path's population on the dataset ``ds`` (K=1000, ALIE f=5,
    trimmed mean b=5), on the card by default."""
    from blades_tpu_torch import Simulator

    k, _, f = CCT2_SHAPE
    return Simulator(dataset=ds, attack="alie", num_byzantine=f, aggregator="trimmedmean",
                     aggregator_kws={"num_byzantine": f}, seed=1, log_path=str(log_root / name),
                     **kw)


def sampled_round_ms(torch, sim, reps: int = 3) -> list:
    """Warm rounds of ``sim``'s engine from its state (not applied), each
    sampling its own batch from the store first, as a round of the
    Simulator does; host wall with a device sync, ms."""
    from blades_tpu_torch.utils import rng

    eng, state, fl = sim.engine, sim.server.state, sim.dataset

    def one(i):
        batch = list(fl.sample_round(rng.generator(sim.seed, 200 + i, rng.DATA,
                                                   device=eng.device), 1, 32))
        return eng.run_round_donated(state, batch, 0.1, 1.0, sim.seed)

    one(0)
    torch.cuda.synchronize()
    walls = []
    for i in range(reps):
        t0 = time.perf_counter()
        one(i + 1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def placed_sampler_check(torch, fl) -> dict:
    """The store ``fl`` placed on a virtual ``(4, 1)`` mesh of the card
    (``FLDataset.place``): one round's placed batches (1 step of batch 32,
    the transform and the normalizer per row) against the unplaced
    sampler's from the same generator state, bit for bit, and each
    sampler's device time (CUDA events); then the store is gathered whole
    again (``FLDataset.to``)."""
    from blades_tpu_torch.parallel import make_mesh, make_plan
    from blades_tpu_torch.utils import rng

    home = fl.device
    gen = lambda: rng.generator(1, 302, rng.DATA, device=home)  # noqa: E731
    g_plain, g_placed = gen(), gen()
    cx, cy = fl.sample_round(g_plain, 1, 32)
    plain_ms = time_ms(lambda: fl.sample_round(gen(), 1, 32), reps=10)
    plan = make_plan(make_mesh([_entry(torch, home)] * 4, (4, 1)))
    fl.place(plan)
    px, py = fl.sample_round(g_placed, 1, 32)
    bitwise = (torch.equal(px.local, cx) and torch.equal(py.local, cy)
               and torch.equal(g_plain.get_state(), g_placed.get_state()))
    rows = [[a, b, str(t.device)] for t, a, b in zip(px.pieces, px.starts, px.starts[1:])]
    want = [[r.start, r.stop, str(plan.row_device(i))]
            for i, r in enumerate(plan.row_ranges(fl.num_clients))]
    placed_ms = time_ms(lambda: fl.sample_round(gen(), 1, 32), reps=10)
    was_placed = fl.placed
    del cx, cy, px, py
    fl.to(home)
    return {"mesh_shape": [4, 1], "placed": was_placed, "rows": rows, "rows_ok": rows == want,
            "bit_for_bit": bitwise,
            "sampler_ms": {"unplaced": plain_ms, "placed": placed_ms},
            "unplaced_after": not fl.placed}


def phase_data_cifar10(torch, trimmed, dev, syn_fl, card: str, log_root: Path,
                       data_root: Path):
    """CIFAR-10 from files (slice 4): the pickles written at their real
    size, loaded and Dirichlet-split (alpha 0.1) over K=1000 clients into a
    uint8 store on the card; then bf16 CCT-2 (ALIE f=5, trimmed mean b=5, 4
    chunks, 1 step of batch 32) through Simulator.run, the sampler
    cropping, flipping, erasing and normalizing inside the round:
    DATA_EAGER_ROUNDS rounds one by one, then the same rounds as one graph
    block (held bit for bit: state, train, variance and test records), a
    warm block's host syncs and, under torch.profiler, its kernel events
    against its counted launches. Beside it: the warm round (sampling
    included) on this store and on the float32 Synthetic store ``syn_fl``
    without a transform; the sampler's device time on each store; the
    transform and the normalizer alone on a round's [32000, 32, 32, 3]
    uint8 batch; the card's transform and normalizer against the CPU's on
    the same batch and draws; and the store placed on a virtual (4, 1)
    mesh of the card, its sampler held bit for bit to the unplaced one
    (:func:`placed_sampler_check`). Returns the dataset, the launches
    by path, the graph launches and the profiler's kernel events."""
    from torch.profiler import ProfilerActivity, profile

    from blades_tpu_torch.datasets import CIFAR10
    from blades_tpu_torch.datasets.augment import (
        CifarParams,
        apply_cifar_transform,
        draw_cifar_params,
    )
    from blades_tpu_torch.utils import rng

    k, _, f = CCT2_SHAPE
    t0 = time.perf_counter()
    write_cifar10(data_root)
    write_s = time.perf_counter() - t0
    ds = CIFAR10(data_root=str(data_root), num_clients=k, iid=False, alpha=DATA_ALPHA,
                 train_bs=32, cache=False)
    t0 = time.perf_counter()
    ds.load_raw()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl = ds.get_dls(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(fl.train_x.dtype == torch.uint8 and fl.train_x.device.type == dev.type,
          f"data_cifar10: store {fl.train_x.dtype} on {fl.train_x.device}")
    store = {n: t.numel() * t.element_size() for n, t in (
        ("train_x", fl.train_x), ("train_y", fl.train_y), ("test_x", fl.test_x_raw))}

    run = dict(model="cct_2_3x2_32", global_rounds=DATA_EAGER_ROUNDS, local_steps=1,
               server_lr=1.0, client_lr=0.1, client_chunks=CCT2_CHUNKS,
               compute_dtype="bfloat16", validate_interval=DATA_EAGER_ROUNDS)
    out = {}
    for mode, kw in (("eager", {}), ("graph", dict(block_size=DATA_BLOCK_ROUNDS))):
        gc.collect()
        sim = data_simulator(ds, log_root, f"data_cifar10_{mode}")
        check(sim.device.type == dev.type, f"data_cifar10: device {sim.device}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trimmed.trimmed_mean_launches = 0
        t0 = time.perf_counter()
        times = sim.run(**run, **kw)
        torch.cuda.synchronize()
        out[mode] = dict(sim=sim, round_s=times, wall_s=time.perf_counter() - t0,
                         launches=trimmed.trimmed_mean_launches,
                         peak=torch.cuda.max_memory_allocated())
    eng = out["graph"]["sim"].engine
    differs = _states_differ(torch, out["eager"]["sim"].server.state,
                             out["graph"]["sim"].server.state)
    records = {kind: _records(log_root / "data_cifar10_eager", kind)
               == _records(log_root / "data_cifar10_graph", kind)
               for kind in ("train", "variance", "test")}
    train = _records(log_root / "data_cifar10_eager", "train")
    test = _records(log_root / "data_cifar10_eager", "test")

    # a warm block: its host syncs, and under the profiler its kernel events
    state, sampler, r = out["graph"]["sim"].server.state, fl.sampler(1, 32), DATA_BLOCK_ROUNDS
    nxt = list(range(DATA_EAGER_ROUNDS + 1, DATA_EAGER_ROUNDS + 1 + r))

    def block():
        _, ms, _ = eng.run_block(state, nxt, [0.1] * r, [1.0] * r, 1, sampler=sampler)
        return torch.stack(list(ms)).cpu()

    block()
    syncs = host_syncs(torch, block)
    block()
    prof = profiled_block(torch, trimmed, block)
    wall, dev, events, counted = prof["wall_ms"], prof["dev"], prof["events"], prof["counted"]

    # the round with sampling on this store and on the float32 Synthetic one
    syn = data_simulator(syn_fl, log_root, "data_cifar10_synthetic")
    syn.run(**dict(run, global_rounds=0))
    round_ms = {"cifar10_uint8_augmented": sampled_round_ms(torch, out["eager"]["sim"]),
                "synthetic_float32": sampled_round_ms(torch, syn)}
    del syn

    # the sampler's time on each store (CUDA events, and the union of its
    # kernels under the profiler, over SAMPLER_CALLS calls), and the
    # transform and the normalizer alone on a round's batch (CUDA events)
    sampler_ms, sampler_profiled = {}, {}
    for name, store_fl in (("cifar10_uint8_augmented", fl), ("synthetic_float32", syn_fl)):
        gen = rng.generator(1, 300, rng.DATA, device=store_fl.device)
        sampler_ms[name] = time_ms(lambda: store_fl.sample_round(gen, 1, 32), reps=20)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as sprof:
            for _ in range(SAMPLER_CALLS):
                store_fl.sample_round(gen, 1, 32)
            torch.cuda.synchronize()
        kernels = device_kernels(torch, sprof)
        sampler_profiled[name] = {
            "ms": _union_ms([(e.time_range.start, e.time_range.end) for e in kernels])
            / SAMPLER_CALLS, "kernels_per_call": len(kernels) / SAMPLER_CALLS}
    placed = placed_sampler_check(torch, fl)
    gen = rng.generator(1, 301, rng.DATA, device=fl.device)
    u = torch.rand(fl.train_y.shape, generator=gen, device=fl.device)
    idx = torch.argsort(u, dim=1)[:, :32]
    flat = fl.train_x[torch.arange(k, device=fl.device)[:, None], idx].reshape(-1, 32, 32, 3)
    check(flat.shape == (AUGMENT_BATCH, 32, 32, 3), f"data_cifar10: batch {tuple(flat.shape)}")
    draws = draw_cifar_params(gen, AUGMENT_BATCH, 32, 32)
    transform_ms = time_ms(lambda: apply_cifar_transform(flat, draws), reps=20)
    draw_ms = time_ms(lambda: draw_cifar_params(gen, AUGMENT_BATCH, 32, 32), reps=20)
    normalize_ms = time_ms(lambda: fl.normalize(flat), reps=20)
    card_img = apply_cifar_transform(flat, draws)
    cpu_img = apply_cifar_transform(flat.cpu(), CifarParams(*(t.cpu() for t in draws)))
    transform_equal = bool(torch.equal(card_img.cpu(), cpu_img))
    normalize_equal = bool(torch.equal(fl.normalize(card_img).cpu(), fl.normalize(cpu_img)))
    erased = int(draws.erase.sum())
    del card_img, cpu_img, flat

    ev, gr = out["eager"], out["graph"]
    emit({"phase": "data_cifar10", "clients": k, "byzantine": f, "alpha": DATA_ALPHA,
          "train_images": CIFAR10_TRAIN, "test_images": CIFAR10_TEST,
          "write_files_s": write_s, "load_s": load_s, "load_partition_to_card_s": build_s,
          "n_max": int(fl.train_x.shape[1]), "clients_without_samples":
              int((fl.train_counts == 0).sum()),
          "store_bytes": store, "synthetic_float32_train_x_bytes":
              syn_fl.train_x.numel() * syn_fl.train_x.element_size(),
          "eager_round_s": ev["round_s"], "graph_round_s": gr["round_s"],
          "eager_wall_s": ev["wall_s"], "graph_wall_s": gr["wall_s"],
          "mode": eng.last_block_mode, "capture_s": eng.last_graph.capture_seconds,
          "warmup_s": eng.last_graph.warmup_seconds,
          "eager_launches": ev["launches"], "graph_launches": gr["launches"],
          "peak_mem_bytes": [ev["peak"], gr["peak"]], "block_differs": differs,
          "records_equal": records, "train_loss": [r["Loss"] for r in train],
          "test": test,
          "warm_block_host_syncs": sum(syncs.values()), "warm_block_host_sync_sites": syncs,
          "profiled_block_wall_ms": wall, "profiled_block_busy_ms": dev["busy_ms"],
          "profiled_block_busy_share": dev["busy_ms"] / wall,
          "profiled_block_kernel_events": events, "profiled_block_counted_launches": counted,
          "profiled_block_events_by_attempt": prof["events_by_attempt"],
          "warm_round_ms": round_ms, "sampler_ms": sampler_ms,
          "sampler_profiled": sampler_profiled, "placed_sampler": placed,
          "augment_batch": AUGMENT_BATCH, "transform_ms": transform_ms, "draw_ms": draw_ms,
          "normalize_ms": normalize_ms, "images_erased": erased,
          "transform_card_equals_cpu": transform_equal,
          "normalize_card_equals_cpu": normalize_equal, "card": card})
    check(eng.last_block_mode == "graph", f"data_cifar10: {eng.last_block_reason}")
    check(not differs and all(records.values()),
          f"data_cifar10: the block differs from its rounds: {differs} {records}")
    check(ev["launches"] == gr["launches"] == DATA_EAGER_ROUNDS,
          f"data_cifar10: launches {ev['launches']} / {gr['launches']}")
    check(events == counted == r, f"data_cifar10: {events} kernel events, {counted} counted")
    check(sum(syncs.values()) == 1, f"data_cifar10: a warm block synced {syncs}")
    check(all(math.isfinite(x["Loss"]) for x in train + test), f"data_cifar10: {train} {test}")
    check(transform_equal and normalize_equal, "data_cifar10: card and CPU augmentations differ")
    check(placed["placed"] and placed["bit_for_bit"] and placed["rows_ok"]
          and placed["unplaced_after"], f"data_cifar10: the placed sampler {placed}")
    launches = {"cct2_bf16_cifar10_files": ev["launches"],
                "cct2_bf16_cifar10_files_graph_block": gr["launches"]}
    graph = {"cct2_bf16_cifar10_files_graph_block": gr["launches"],
             "cct2_bf16_cifar10_files_profiled_block": counted}
    del out
    return ds, launches, graph, {"cct2_bf16_cifar10_files_profiled_block": events}


def phase_data_mnist(torch, trimmed, dev, card: str, log_root: Path, base: Path) -> int:
    """MNIST from gzipped IDX files (slice 4), written at their real size
    under ``base/data``: the MLP at K=1000 (ALIE f=5, trimmed mean b=5,
    IID) for DATA_MLP_ROUNDS rounds through Simulator.run, the uint8 store
    normalized in the sampler; then the mini example's configuration
    (K=10, ALIE f=4, mean) through ``blades_tpu_torch/examples/
    mini_example.py`` run from ``base`` with MINI_ROUNDS and MINI_STEPS
    set. Returns the MLP run's kernel launches."""
    import contextlib
    import os

    from blades_tpu_torch.datasets import MNIST
    from blades_tpu_torch.examples import mini_example

    t0 = time.perf_counter()
    write_mnist(base / "data")
    write_s = time.perf_counter() - t0
    k, _, f = CCT2_SHAPE
    t0 = time.perf_counter()
    ds = MNIST(data_root=str(base / "data"), num_clients=k, train_bs=32, cache=False)
    fl = ds.get_dls(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sim = data_simulator(ds, log_root, "data_mnist_mlp")
    torch.cuda.synchronize()
    trimmed.trimmed_mean_launches = 0
    times = sim.run(model="mlp", global_rounds=DATA_MLP_ROUNDS, local_steps=1, server_lr=1.0,
                    client_lr=0.1, validate_interval=DATA_MLP_ROUNDS)
    torch.cuda.synchronize()
    launches = trimmed.trimmed_mean_launches
    train = _records(log_root / "data_mnist_mlp", "train")
    test = _records(log_root / "data_mnist_mlp", "test")
    del sim, fl, ds

    env = {n: os.environ.get(n) for n in ("MINI_ROUNDS", "MINI_STEPS")}
    os.environ.update(MINI_ROUNDS=str(MINI_ROUNDS), MINI_STEPS=str(MINI_STEPS))
    try:
        trimmed.trimmed_mean_launches = 0
        t0 = time.perf_counter()
        with contextlib.chdir(base):
            mini = mini_example.main([])
        torch.cuda.synchronize()
        mini_s = time.perf_counter() - t0
    finally:
        for n, v in env.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
    mini_train = _records(base / "outputs", "train")
    mini_test = _records(base / "outputs", "test")
    emit({"phase": "data_mnist", "clients": k, "byzantine": f, "write_files_s": write_s,
          "load_partition_to_card_s": build_s, "round_s": times, "launches": launches,
          "train_loss": [r["Loss"] for r in train], "test": test,
          "mini_example": {"clients": 10, "byzantine": 4, "aggregator": "mean",
                           "rounds": MINI_ROUNDS, "local_steps": MINI_STEPS,
                           "device": str(mini.device), "wall_s": mini_s,
                           "store_dtype": str(mini.dataset.train_x.dtype),
                           "train_loss": [r["Loss"] for r in mini_train], "test": mini_test,
                           "launches": trimmed.trimmed_mean_launches},
          "card": card})
    check(launches == DATA_MLP_ROUNDS, f"data_mnist: launches {launches}")
    check(len(train) == DATA_MLP_ROUNDS and len(mini_train) == MINI_ROUNDS,
          f"data_mnist: {len(train)} and {len(mini_train)} train records")
    check(mini.device.type == dev.type and mini.dataset.train_x.dtype == torch.uint8,
          f"data_mnist: mini example on {mini.device}, {mini.dataset.train_x.dtype}")
    check(all(math.isfinite(r["Loss"]) for r in train + test + mini_train + mini_test),
          "data_mnist: non-finite loss")
    return launches


def phase_checkpoint(torch, trimmed, ds, card: str, log_root: Path, ckpt_dir: Path) -> dict:
    """Checkpoint and resume (slice 5) on bf16 CCT-2 at K=1000 from the
    CIFAR-10 files (ALIE f=5, trimmed mean b=5) under the fault model of
    fault_round: an uninterrupted CKPT_ROUNDS-round run; against it a run
    that checkpoints every CKPT_AT rounds, raises from on_round_end at
    round CKPT_CRASH_AT (the crash autosave overwrites the checkpoint with
    that round's state) and is resumed by a fresh Simulator; then blocks of
    CKPT_BLOCK (captured graphs) that stop at a block boundary with a
    checkpoint and are resumed in blocks. Params, the straggler buffer,
    every state tensor and every train record must be equal. Then the
    final state's save and restore, timed, and the file's size. Returns
    the kernel's launches (0: the masked trimmed mean replaces it)."""
    from blades_tpu_torch.utils.checkpoint import checkpoint_file, restore_state, save_state

    run = dict(model="cct_2_3x2_32", local_steps=1, server_lr=1.0, client_lr=0.1,
               client_chunks=CCT2_CHUNKS, compute_dtype="bfloat16",
               validate_interval=CKPT_ROUNDS + 1, fault_model=FAULTS)
    launches = {}

    def go(name, sim=None, **kw):
        gc.collect()
        sim = sim or data_simulator(ds, log_root, name)
        trimmed.trimmed_mean_launches = 0
        times = sim.run(**run, **kw)
        torch.cuda.synchronize()
        launches[name] = launches.get(name, 0) + trimmed.trimmed_mean_launches
        return sim, times

    ref, _ = go("ckpt_ref", global_rounds=CKPT_ROUNDS)
    ref_train = _records(log_root / "ckpt_ref", "train")
    ck = ckpt_dir / "state.npz"

    def crash(rnd, state, m):
        if rnd == CKPT_CRASH_AT:
            raise RuntimeError("chip_smoke: simulated crash")

    crashed = data_simulator(ds, log_root, "ckpt_crash")
    try:
        go("ckpt_crash", sim=crashed, global_rounds=CKPT_ROUNDS, checkpoint_path=str(ck),
           checkpoint_interval=CKPT_AT, on_round_end=crash)
        raise AssertionError("chip_smoke: the crash did not propagate")
    except RuntimeError as err:
        check("simulated crash" in str(err), f"checkpoint: {err!r}")
    torch.cuda.synchronize()
    crash_train = _records(log_root / "ckpt_crash", "train")
    autosaved = restore_state(str(ck), crashed.server.state).round_idx
    del crashed
    resumed, times = go("ckpt_crash", global_rounds=CKPT_ROUNDS, checkpoint_path=str(ck),
                        resume=True)
    resumed_train = crash_train + _records(log_root / "ckpt_crash", "train")
    differs = _states_differ(torch, ref.server.state, resumed.server.state)
    stale_equal = _same(torch, ref.server.state.fault_state["stale"],
                        resumed.server.state.fault_state["stale"])
    stragglers = int(ref.server.state.fault_state["has"].sum())

    ck2 = ckpt_dir / "blocks.npz"
    first, _ = go("ckpt_blocks", global_rounds=CKPT_AT, block_size=CKPT_BLOCK,
                  checkpoint_path=str(ck2), checkpoint_interval=CKPT_AT)
    first_train = _records(log_root / "ckpt_blocks", "train")
    mode = first.engine.last_block_mode
    del first
    blocks, block_times = go("ckpt_blocks", global_rounds=CKPT_ROUNDS, block_size=CKPT_BLOCK,
                             checkpoint_path=str(ck2), resume=True)
    blocks_train = first_train + _records(log_root / "ckpt_blocks", "train")
    block_differs = _states_differ(torch, ref.server.state, blocks.server.state)
    mode_resumed = blocks.engine.last_block_mode

    state = resumed.server.state
    ck3 = ckpt_dir / "timed.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_state(str(ck3), state)
    save_s = time.perf_counter() - t0
    size = Path(checkpoint_file(str(ck3))).stat().st_size
    t0 = time.perf_counter()
    back = restore_state(str(ck3), state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    round_trip = _states_differ(torch, state, back)
    leftovers = sorted(p.name for p in ckpt_dir.iterdir() if p.name.endswith(".tmp"))
    state_bytes = sum(t.numel() * t.element_size() for t in _tensors(torch, state))
    emit({"phase": "checkpoint", "clients": CCT2_SHAPE[0], "faults": FAULTS,
          "rounds": CKPT_ROUNDS, "checkpoint_interval": CKPT_AT, "crash_at": CKPT_CRASH_AT,
          "autosaved_round": autosaved, "resumed_round_s": times, "differs": differs,
          "straggler_buffer_equal": stale_equal, "buffer_rows_held": stragglers,
          "train_equal": resumed_train == ref_train, "block_size": CKPT_BLOCK,
          "block_mode": [mode, mode_resumed], "block_round_s": block_times,
          "block_differs": block_differs, "block_train_equal": blocks_train == ref_train,
          "file_bytes": size, "state_bytes": state_bytes, "save_s": save_s,
          "restore_s": restore_s, "round_trip_differs": round_trip, "tmp_left": leftovers,
          "launches": launches, "card": card})
    check(autosaved == CKPT_CRASH_AT, f"checkpoint: the autosave holds round {autosaved}")
    check(len(times) == CKPT_ROUNDS - CKPT_CRASH_AT, f"checkpoint: resumed {len(times)} rounds")
    check(not differs and stale_equal and resumed_train == ref_train,
          f"checkpoint: the resumed run differs: {differs}")
    check(mode == mode_resumed == "graph", f"checkpoint: blocks ran {mode} / {mode_resumed}")
    check(not block_differs and blocks_train == ref_train,
          f"checkpoint: the block-boundary resume differs: {block_differs}")
    check(not round_trip and not leftovers, f"checkpoint: {round_trip} {leftovers}")
    check(not any(launches.values()), f"checkpoint: the kernel launched {launches}")
    for path in (ck, ck2, ck3):
        path.unlink()
    return launches


def write_cifar100(root: Path, seed: int = 0) -> Path:
    """CIFAR-100's python-pickle layout at its published size under
    ``root``: ``cifar-100-python/train`` (50,000 images) and ``test``
    (10,000), seeded uint8 pixels and ``fine_labels``."""
    import pickle

    import numpy as np

    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    r = np.random.RandomState(seed)
    for name, n in (("train", CIFAR10_TRAIN), ("test", CIFAR10_TEST)):
        with open(d / name, "wb") as fh:
            pickle.dump({b"data": r.randint(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": r.randint(0, 100, n).tolist()}, fh)
    return d


def baseline_stores(torch, dev, data_root: Path) -> dict:
    """The BASELINE models' stores on the card, from CIFAR-10 and CIFAR-100
    files written at their published size (IID, the loaders' default):
    CIFAR-10 over RESNET_CLIENTS and over RESNET_STREAM_CLIENTS clients,
    CIFAR-100 over WRN_CLIENTS. Emits the write and load seconds."""
    from blades_tpu_torch.datasets import CIFAR10, CIFAR100

    t0 = time.perf_counter()
    write_cifar10(data_root / "cifar10", seed=11)
    write_cifar100(data_root / "cifar100", seed=12)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stores = {}
    for name, cls, root, k in (("cifar10_k100", CIFAR10, "cifar10", RESNET_CLIENTS),
                               ("cifar10_k1000", CIFAR10, "cifar10", RESNET_STREAM_CLIENTS),
                               ("cifar100", CIFAR100, "cifar100", WRN_CLIENTS)):
        ds = cls(data_root=str(data_root / root), num_clients=k, train_bs=32, cache=False)
        stores[name] = ds.get_dls(dev)
        dtype = stores[name].train_x.dtype
        check(dtype == torch.uint8, f"{name}: store {dtype}")
    torch.cuda.synchronize()
    emit({"phase": "baseline_data", "write_s": write_s, "load_s": time.perf_counter() - t0,
          "stores": {n: [fl.num_clients, list(fl.train_x.shape), list(fl.test_x.shape)]
                     for n, fl in stores.items()}})
    return stores


def baseline_run(torch, trimmed, fl, log_root: Path, name: str, model: str, rounds: int,
                 chunks: int, dtype=None, attack=None, byzantine: int = 0,
                 aggregator: str = "mean", aggregator_kws=None, local_steps: int = 1,
                 streaming: bool = False, keep_updates: bool = False) -> dict:
    """``rounds`` rounds of ``model`` through Simulator.run on the store
    ``fl`` (1 step of batch 32 unless ``local_steps``, ``chunks`` client
    chunks, no evaluation), each round's metrics read where the simulator
    logs them (``run(streaming=True)`` refuses ``on_round_end``); with
    ``keep_updates`` the engine keeps each round's matrix (an
    ``on_round_end`` asks for it). Returns
    the simulator, the records, the round times (the first one cold), the
    kernel's launches, the peak memory and the engine's shape."""
    from blades_tpu_torch import Simulator

    gc.collect()
    torch.cuda.empty_cache()
    sim = Simulator(dataset=fl, attack=attack, num_byzantine=byzantine, aggregator=aggregator,
                    aggregator_kws=aggregator_kws or {}, seed=1, log_path=str(log_root / name))
    check(sim.device.type == "cuda", f"{name}: the simulator runs on {sim.device}")
    seen, log_train = [], sim.log_train

    def record(rnd, steps, m):
        log_train(rnd, steps, m)
        seen.append(dict(loss=float(m.train_loss), top1=float(m.train_top1),
                         agg_norm=float(m.agg_norm), variance=float(m.update_variance)))

    sim.log_train = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    trimmed.trimmed_mean_launches = 0
    # a vmapped op without a batching rule would run the clients one by one
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop because we have not "
                                "yet implemented the batching rule")
        times = sim.run(model=model, global_rounds=rounds, local_steps=local_steps,
                        server_lr=1.0, client_lr=0.1, validate_interval=rounds + 1,
                        client_chunks=chunks, compute_dtype=dtype, streaming=streaming,
                        on_round_end=(lambda *a: None) if keep_updates else None)
    torch.cuda.synchronize()
    eng = sim.engine
    out = dict(sim=sim, seen=seen, round_s=times, launches=trimmed.trimmed_mean_launches,
               peak=torch.cuda.max_memory_allocated(), resident=resident, dim=eng.dim,
               clients=eng.num_clients,
               client_chunks=eng.client_chunks, chunk_size=eng.chunk_size,
               peak_update_bytes=eng.peak_update_bytes)
    check(len(seen) == rounds, f"{name}: {len(seen)} rounds")
    numbers = [v for r in seen for v in (r["loss"], r["agg_norm"], r["variance"])]
    check(all(map(math.isfinite, numbers)), f"{name}: non-finite {numbers}")
    check(eng.streaming == streaming, f"{name}: streaming {eng.streaming}")
    return out


def baseline_record(run: dict) -> dict:
    """A baseline run's record fields."""
    return {"clients": run["clients"], "dim": run["dim"], "client_chunks": run["client_chunks"],
            "chunk_size": run["chunk_size"], "round_s": run["round_s"],
            "cold_round_s": run["round_s"][0], "warm_round_s": run["round_s"][1:],
            "kernel_launches": run["launches"], "peak_mem_bytes": run["peak"],
            "resident_bytes_before": run["resident"],
            "peak_update_bytes": run["peak_update_bytes"],
            "train_loss": [r["loss"] for r in run["seen"]],
            "train_top1": [r["top1"] for r in run["seen"]],
            "agg_norm": [r["agg_norm"] for r in run["seen"]]}


def eager_round(sim, rnd: int = 99):
    """One more round of ``sim``'s engine from its state (not applied), on a
    fresh sample of 1 step of batch 32."""
    from blades_tpu_torch.utils import rng

    eng, state = sim.engine, sim.server.state
    cx, cy = sim.dataset.sample_round(rng.generator(sim.seed, rnd, rng.DATA, device=eng.device),
                                      1, 32)
    return lambda: eng.run_round(state, cx, cy, 0.1, 1.0, seed=sim.seed)


def phase_resnet18_round(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """BASELINE config 2's shape: ResNet-18 on the CIFAR-10 files at K=100,
    fedsgd (1 local step of batch 32), no attack, mean; f32 and bf16, a
    cold round and RESNET_WARM_ROUNDS warm rounds each through
    Simulator.run, then one warm round under torch.profiler (wall, device
    busy time and share). Returns the kernel's launches by dtype (0: the
    mean)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        run = baseline_run(torch, trimmed, fl, log_root, f"resnet18_{dtype}", "resnet18",
                           1 + RESNET_WARM_ROUNDS, RESNET_CHUNKS[dtype],
                           None if dtype == "float32" else dtype)
        prof = profiled_block(torch, trimmed, eager_round(run["sim"]))
        emit({"phase": "resnet18_round", "dtype": dtype, "attack": None, "aggregator": "mean",
              **baseline_record(run), "profiled_wall_ms": prof["wall_ms"],
              "device_busy_ms": prof["dev"]["busy_ms"],
              "device_busy_share": prof["dev"]["busy_ms"] / prof["wall_ms"],
              "device_streams": prof["dev"]["streams"],
              "other_top_ms": prof["dev"]["other_top_ms"][:5], "card": card})
        check(run["dim"] == RESNET18_DIM, f"resnet18: D = {run['dim']}")
        check(run["launches"] == 0 and prof["counted"] == 0, "resnet18_round: the mean launched")
        check(prof["dev"]["busy_ms"] > 0, "resnet18_round: no device time in the profiled round")
        out[f"resnet18_round_{dtype}"] = run["launches"]
        del run
    return out


def phase_resnet18_kernel(torch, trimmed, fl, card: str, log_root: Path) -> tuple:
    """The slice's kernel path: ResNet-18 on the CIFAR-10 files at K=100,
    ALIE f=10 and trimmed mean b=10, bf16, RESNET_KERNEL_ROUNDS rounds
    through Simulator.run (the kernel once a round). The last round's own
    [100, 11173962] matrix then goes to the kernel and its plain version
    (TOL), both timed with the library call and the bound (those launches
    are not counted); a warm round under torch.profiler, whose kernel
    events must equal its counted launches; and, with cuDNN's
    deterministic algorithms, RESNET_BLOCK_ROUNDS rounds one by one and
    as one captured graph block, held bit for bit. Should they differ, the
    rounds run a second time: if the eager rounds differ between the two
    runs, the round is not deterministic on the card and that is
    recorded; otherwise the phase fails. Returns (the launches of the
    eager run, the block's launches, its profiler events, the kernel's
    timings and its max error)."""
    k, d, b = RESNET18_SHAPE
    run = baseline_run(torch, trimmed, fl, log_root, "resnet18_kernel", "resnet18",
                       RESNET_KERNEL_ROUNDS, RESNET_CHUNKS["bfloat16"], "bfloat16",
                       attack="alie", byzantine=b, aggregator="trimmedmean",
                       aggregator_kws={"num_byzantine": b}, keep_updates=True)
    sim = run["sim"]
    check(run["launches"] == RESNET_KERNEL_ROUNDS,
          f"resnet18_kernel: {run['launches']} launches in {RESNET_KERNEL_ROUNDS} rounds")
    u = sim.engine.last_updates
    check(tuple(u.shape) == (k, d) and u.dtype == torch.float32, f"matrix {tuple(u.shape)}")
    got = trimmed.trimmed_mean_cuda(u, b)
    ref = trimmed.trimmed_mean_plain(u, b)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, **TOL))
    # ALIE's rows tie in every column: the columns the kernel's candidate
    # lists overflow take its general route
    ties = int((u[:RESNET_BYZANTINE] == u[0]).all(dim=0).sum())
    kern = time_ms(lambda: trimmed.trimmed_mean_cuda(u, b), reps=20)
    plain = time_ms(lambda: trimmed.trimmed_mean_plain(u, b), reps=3, warmup=1)
    lib = time_ms(lambda: torch.sort(u, 0)[0][b:k - b].mean(0), reps=3, warmup=1)
    bnd, by = bound_ms(k, d)
    timings = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
    # the same shape without ties, made on the card: what the ties cost
    g = torch.Generator(device=u.device).manual_seed(0)
    untied = torch.randn(k, d, device=u.device, generator=g) * 1e-2
    untied_ms = time_ms(lambda: trimmed.trimmed_mean_cuda(untied, b), reps=20)
    untied_ok = bool(torch.allclose(trimmed.trimmed_mean_cuda(untied, b),
                                    trimmed.trimmed_mean_plain(untied, b), **TOL))
    del untied
    prof = profiled_block(torch, trimmed, eager_round(sim))
    rec = {"phase": "resnet18_kernel", "dtype": "bfloat16", "attack": "alie", "byzantine": b,
           "aggregator": "trimmedmean", "b": b, **baseline_record(run),
           "kernel_vs_plain_max_abs_err": err, "alie_tied_columns": ties, **timings,
           "share_of_bound": bnd / kern, "untied_matrix_ms": untied_ms,
           "profiler_ms": profiled_kernel_ms(torch, lambda: trimmed.trimmed_mean_cuda(u, b)),
           "profiled_round_wall_ms": prof["wall_ms"],
           "profiled_round_busy_share": prof["dev"]["busy_ms"] / prof["wall_ms"],
           "profiled_round_kernel_events": prof["events"],
           "profiled_round_counted_launches": prof["counted"],
           "profiled_round_events_by_attempt": prof["events_by_attempt"]}
    check(ok, f"resnet18_kernel: kernel and plain version differ by {err} (tol {TOL})")
    check(untied_ok, "resnet18_kernel: kernel and plain version differ on the untied matrix")
    check(math.isclose(float(torch.linalg.vector_norm(got)), run["seen"][-1]["agg_norm"],
                       rel_tol=1e-6), "resnet18_kernel: the round applied another aggregate")
    check(prof["counted"] == 1 and prof["events"] == prof["counted"],
          f"resnet18_kernel: {prof['events']} profiler events, {prof['counted']} launches")
    launches = run["launches"]
    del run, sim, u, got, ref
    with deterministic_cudnn():
        block_kw = dict(model="resnet18", byzantine=b, aggregator_kws={"num_byzantine": b},
                        chunks=RESNET_CHUNKS["bfloat16"], warm_block=False)
        blocks = [engine_blocks(torch, trimmed, fl, log_root, "resnet18_block",
                                RESNET_BLOCK_ROUNDS, **block_kw)]
        if blocks[0]["differs"]:
            blocks.append(engine_blocks(torch, trimmed, fl, log_root, "resnet18_block_again",
                                        RESNET_BLOCK_ROUNDS, **block_kw))
    first = blocks[0]
    eager_repeats = (None if len(blocks) == 1 else
                     not _states_differ(torch, first["seq_state"], blocks[1]["seq_state"]))
    rec.update(block_mode=first["mode"], block_reason=first["reason"],
               block_differs=first["differs"][:10], block_round_s=first["round_s"],
               block_s=first["block_s"], block_launches=first["launches"],
               block_capture_s=first["capture_s"], block_warmup_s=first["warmup_s"],
               block_peak_bytes=first["peak"], eager_rounds_repeat=eager_repeats,
               card=card)
    if eager_repeats is False:
        rec["block_note"] = ("the eager rounds differ between two runs with cuDNN's "
                             "deterministic algorithms: the round is not deterministic "
                             "on the card, so the block cannot be held bit for bit")
    emit(rec)
    check(first["mode"] == "graph", f"resnet18 block ran {first['mode']}: {first['reason']}")
    check(not first["differs"] or eager_repeats is False,
          f"resnet18 block differs from its rounds: {first['differs'][:5]}")
    check(first["launches"] == RESNET_BLOCK_ROUNDS and first["graph_kernel_launches"] == 1,
          f"resnet18 block: {first['launches']} launches")
    return launches, first["launches"], timings, err


def phase_resnet18_krum(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """BASELINE config 3's shape: ResNet-18 at K=100, IPM f=10 and Krum
    (f=10), bf16, KRUM_STEPS local steps of batch 32 (config 3 asks for 5
    local epochs; cut to 5 steps), KRUM_ROUNDS rounds; Krum's own time, host
    syncs and extra memory on the last round's matrix. Returns the
    kernel's launches (0)."""
    f = RESNET18_SHAPE[2]
    run = baseline_run(torch, trimmed, fl, log_root, "resnet18_krum", "resnet18", KRUM_ROUNDS,
                       RESNET_CHUNKS["bfloat16"], "bfloat16", attack="ipm", byzantine=f,
                       aggregator="krum", aggregator_kws={"num_byzantine": f},
                       local_steps=KRUM_STEPS, keep_updates=True)
    eng = run["sim"].engine
    u = eng.last_updates
    cost = call_cost(torch, lambda: eng.aggregator.aggregate(u))
    emit({"phase": "resnet18_krum", "dtype": "bfloat16", "attack": "ipm", "byzantine": f,
          "aggregator": "krum", "local_steps": KRUM_STEPS, **baseline_record(run),
          "krum": cost, "card": card})
    check(run["launches"] == 0, f"resnet18_krum: {run['launches']} kernel launches")
    return run["launches"]


def phase_resnet18_stream(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """BASELINE config 4's shape: ResNet-18 on the CIFAR-10 files at K=1000
    in RESNET_STREAM_CHUNKS chunks, the streaming round (one [chunk, D]
    slab at a time: the dense [1000, D] matrix is 44.7 GB, and the
    median's sort takes 3x that), sign flipping f=5 and the median, bf16,
    RESNET_STREAM_ROUNDS rounds. Returns the kernel's launches (0)."""
    run = baseline_run(torch, trimmed, fl, log_root, "resnet18_stream", "resnet18",
                       RESNET_STREAM_ROUNDS, RESNET_STREAM_CHUNKS, "bfloat16",
                       attack="signflipping", byzantine=MAIN_BYZANTINE, aggregator="median",
                       streaming=True)
    emit({"phase": "resnet18_stream", "dtype": "bfloat16", "attack": "signflipping",
          "byzantine": MAIN_BYZANTINE, "aggregator": "median", **baseline_record(run),
          "dense_matrix_bytes": run["clients"] * run["dim"] * 4, "card": card})
    check(run["peak_update_bytes"] == run["chunk_size"] * run["dim"] * 4,
          f"resnet18_stream: peak_update_bytes {run['peak_update_bytes']}")
    check(run["launches"] == 0, f"resnet18_stream: {run['launches']} kernel launches")
    return run["launches"]


def phase_wrn_stream(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """BASELINE config 5's shape: WideResNet-28-10 (100 classes) on the
    CIFAR-100 files at WRN_CLIENTS clients in WRN_CHUNKS chunks, the
    streaming round (the dense matrix would be 146 GB at K=1000), label
    flipping f=5 and clipped clustering (DnC has no streaming form), bf16,
    1 local step of batch 32 (config 5 asks for fedavg; cut to fedsgd),
    WRN_ROUNDS rounds. Returns the kernel's launches (0)."""
    run = baseline_run(torch, trimmed, fl, log_root, "wrn_stream", "wrn_28_10", WRN_ROUNDS,
                       WRN_CHUNKS, "bfloat16", attack="labelflipping", byzantine=MAIN_BYZANTINE,
                       aggregator="clippedclustering", streaming=True)
    emit({"phase": "wrn_stream", "dtype": "bfloat16", "attack": "labelflipping",
          "byzantine": MAIN_BYZANTINE, "aggregator": "clippedclustering",
          **baseline_record(run), "dense_matrix_bytes": run["clients"] * run["dim"] * 4,
          "card": card})
    check(run["dim"] == WRN_DIM, f"wrn_28_10: D = {run['dim']}")
    check(run["launches"] == 0, f"wrn_stream: {run['launches']} kernel launches")
    return run["launches"]


def phase_resnet_card_vs_cpu(torch, dev, card: str) -> None:
    """One f32 round at full width on the card and on the CPU, from the
    same params and the same batch (1 step of batch 32), mean: ResNet-18 at
    K=2 and WideResNet-28-10 (100 classes) at K=1. Every update row within
    a relative L2 error of RESNET_ROW_REL, and the new params within
    ROUND_TOL; then client 0's float64 gradient on its first
    RESNET_F64_BATCH samples on both, within RESNET_F64_REL (see the
    constants for why the two bars)."""
    from blades_tpu_torch.aggregators import get_aggregator
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.models import build_fns, create_model
    from blades_tpu_torch.ops.pytree import ravel

    for name, classes, k in RESNET_CPU:
        spec = build_fns(create_model(name, num_classes=classes, sample_shape=(32, 32, 3)))
        params = spec.init(torch.Generator().manual_seed(31))
        g = torch.Generator().manual_seed(32)
        cx = torch.rand(k, 1, 32, 32, 32, 3, generator=g) * 2 - 1
        cy = torch.randint(0, classes, (k, 1, 32), generator=g)
        out, secs = {}, {}
        for where in ("cpu", dev):
            eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                              num_clients=k, aggregator=get_aggregator("mean"), device=where,
                              num_classes=classes, noise_sites=spec.noise_sites)
            t0 = time.perf_counter()
            state, _ = eng.run_round(eng.init(params), cx.to(where), cy.to(where), 0.1, 1.0)
            if where != "cpu":
                torch.cuda.synchronize()
            secs[str(where)] = time.perf_counter() - t0
            out[str(where)] = (eng.last_updates.cpu(), ravel(state.params, spec.layout).cpu())
            del eng, state
        (u_cpu, p_cpu), (u_gpu, p_gpu) = out["cpu"], out[str(dev)]
        rel = ((u_gpu - u_cpu).norm(dim=1) / u_cpu.norm(dim=1)).tolist()
        del out, u_cpu, u_gpu
        x1, y1 = cx[0, 0, :RESNET_F64_BATCH], cy[0, 0, :RESNET_F64_BATCH]
        g = {}
        for where in ("cpu", dev):
            for dt in (torch.float32, torch.float64):
                p = {n: t.to(where, dt) for n, t in params.items()}
                grads, _ = torch.func.grad_and_value(
                    lambda q: spec.train_loss_fn(q, x1.to(where, dt), y1.to(where)),
                    has_aux=True)(p)
                g[str(where), dt] = ravel(grads, spec.layout).cpu().double()
                del p, grads
        dist = lambda a, b: float((g[a] - g[b]).norm() / g[b].norm())  # noqa: E731
        rel64 = dist((str(dev), torch.float64), ("cpu", torch.float64))
        emit({"phase": "resnet_card_vs_cpu", "model": name, "classes": classes, "clients": k,
              "dim": p_cpu.shape[0], "row_rel_l2": rel, "bar": RESNET_ROW_REL,
              "params_max_abs_err": float((p_gpu - p_cpu).abs().max()),
              "f64_grad_rel_l2": rel64, "f64_bar": RESNET_F64_REL,
              "f32_vs_f64_grad_rel_l2": {w: dist((w, torch.float32), (w, torch.float64))
                                         for w in ("cpu", str(dev))},
              "relu_inputs_within_1e-6_of_0": relu_near_zero(torch, spec, params, x1),
              "round_s": secs, "card": card})
        check(max(rel) <= RESNET_ROW_REL, f"{name}: update rows {rel} past {RESNET_ROW_REL}")
        check(torch.allclose(p_gpu, p_cpu, **ROUND_TOL), f"{name}: new params differ")
        check(rel64 <= RESNET_F64_REL, f"{name}: float64 gradients {rel64} apart")
        del g, p_cpu, p_gpu
        gc.collect()


# -- the text models and the pretrained loader (slice 11b) ----------------------


def text_stores(torch, dev) -> dict:
    """The text phases' SyntheticText stores on the card: TEXT_TRAIN /
    TEXT_TEST rows over TEXT_CLIENTS clients and TEXT_STREAM_TRAIN rows over
    TEXT_STREAM_CLIENTS (every one of the 100,000 words can be drawn; rows
    of TEXT_MIN_LEN to TEXT_SEQ tokens, padded with 0). Emits the seconds
    of each store's generation, split and copy to the card."""
    from blades_tpu_torch.datasets import SyntheticText

    stores, gen_s = {}, {}
    for name, k, train in (("k100", TEXT_SHAPE[0], TEXT_TRAIN),
                           ("k1000", TEXT_STREAM_CLIENTS, TEXT_STREAM_TRAIN)):
        ds = SyntheticText(vocab_size=TEXT_VOCAB, seq_len=TEXT_SEQ, min_len=TEXT_MIN_LEN,
                           train_size=train, test_size=TEXT_TEST, num_clients=k, train_bs=32,
                           seed=0, cache=False)
        t0 = time.perf_counter()
        stores[name] = fl = ds.get_dls(dev)
        torch.cuda.synchronize()
        gen_s[name] = time.perf_counter() - t0
        check(fl.train_x.dtype == torch.int32 and fl.pad_id == 0, f"text store {name}")
        check(int(fl.train_counts.min()) >= 32, f"text store {name}: a client under 32 rows")
    fl = stores["k100"]
    emit({"phase": "text_data", "vocab": TEXT_VOCAB, "seq_len": TEXT_SEQ,
          "min_len": TEXT_MIN_LEN, "generate_split_copy_s": gen_s,
          "stores": {n: [s.num_clients, list(s.train_x.shape), list(s.test_x.shape)]
                     for n, s in stores.items()},
          "pad_share": float((fl.train_x == 0).float().mean()),
          "distinct_tokens_k100": int(torch.unique(fl.train_x).numel())})
    return stores


def phase_text_round(torch, trimmed, fl, card: str, log_root: Path) -> tuple:
    """``text_cct_2`` at its registry defaults (D = 30,352,643) at K=100,
    ALIE f=10 and trimmed mean b=10, 1 local step of batch 32: a cold round
    and TEXT_ROUNDS - 1 warm rounds through Simulator.run in f32 and in bf16
    (``compute_dtype``), the kernel once a round on [100, 30352643], then
    one warm round under torch.profiler (wall, device busy share, the
    kernel's events against its counted launch). The f32 run's last matrix
    is held against the plain version before that profiled round
    (``text_kernel_check``) and timed once the run is freed
    (``phase_text_kernel``), before the bf16 run. Returns the launches by
    dtype, the kernel's timings and its max error."""
    k, d, b = TEXT_SHAPE
    launches = {}
    for dtype in ("float32", "bfloat16"):
        run = baseline_run(torch, trimmed, fl, log_root, f"text_round_{dtype}", "text_cct_2",
                           TEXT_ROUNDS, TEXT_CHUNKS[dtype],
                           None if dtype == "float32" else dtype,
                           keep_updates=dtype == "float32", attack="alie", byzantine=b,
                           aggregator="trimmedmean", aggregator_kws={"num_byzantine": b})
        held = text_kernel_check(torch, trimmed, run) if dtype == "float32" else None
        prof = profiled_block(torch, trimmed, eager_round(run["sim"]))
        emit({"phase": "text_round", "model": "text_cct_2", "dtype": dtype, "attack": "alie",
              "byzantine": b, "aggregator": "trimmedmean", "b": b, **baseline_record(run),
              "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["dev"]["busy_ms"],
              "device_busy_share": prof["dev"]["busy_ms"] / prof["wall_ms"],
              "device_streams": prof["dev"]["streams"],
              "other_top_ms": prof["dev"]["other_top_ms"][:6],
              "profiled_kernel_events": prof["events"],
              "profiled_counted_launches": prof["counted"],
              "update_matrix_elements": k * d, "card": card})
        check(run["dim"] == d and run["clients"] == k, f"text_round: [{run['clients']}, "
              f"{run['dim']}]")
        check(k * d > 2**31, "text_round: K*D does not pass 2^31")
        check(run["launches"] == TEXT_ROUNDS,
              f"text_round {dtype}: {run['launches']} launches in {TEXT_ROUNDS} rounds")
        check(prof["counted"] == 1 and prof["events"] == 1,
              f"text_round {dtype}: {prof['events']} profiler events, {prof['counted']} launches")
        launches[f"text_cct2_{dtype}"] = run["launches"]
        run.clear()  # the simulator, its engine and state
        del run, prof
        if held is not None:
            timings, err = phase_text_kernel(torch, trimmed, held, card)
            del held
    return launches, timings, err


def text_kernel_check(torch, trimmed, run: dict) -> dict:
    """The kernel on the f32 text round's own [100, 30352643] matrix (K*D
    past 2^31), b=10, held against its plain version at TOL in
    TEXT_KERNEL_SLICES column slices beside the round's engine (the plain
    version's masks, and the library's sort with its int64 indices, take
    about 36 GB on the whole matrix); this launch is not counted. Returns
    the matrix, the kernel's output and what the check found."""
    k, d, b = TEXT_SHAPE
    u = run["sim"].engine.last_updates
    check(tuple(u.shape) == (k, d) and u.dtype == torch.float32 and u.is_contiguous(),
          f"text matrix {tuple(u.shape)}")
    got = trimmed.trimmed_mean_cuda(u, b)
    err, bad, width = 0.0, 0, -(-d // TEXT_KERNEL_SLICES)
    for lo in range(0, d, width):
        ref = trimmed.trimmed_mean_plain(u[:, lo:lo + width], b)
        err = max(err, float((got[lo:lo + width] - ref).abs().max()))
        bad += int((~torch.isclose(got[lo:lo + width], ref, **TOL)).sum())
        del ref
    return dict(u=u, got=got, err=err, bad=bad,
                # the round applied this aggregate: its norm is the round's
                applied=math.isclose(float(torch.linalg.vector_norm(got)),
                                     run["seen"][-1]["agg_norm"], rel_tol=1e-6),
                ties=int((u[:b] == u[0]).all(dim=0).sum()),  # ALIE's f identical rows
                tail=float(u[:, -1].abs().max()))  # the last column, past 2^31 flat


def phase_text_kernel(torch, trimmed, held: dict, card: str) -> tuple:
    """The text round's matrix alone on the card (its run freed): the
    kernel timed on the whole [100, 30352643] beside the bound, the plain
    version and the library call (those launches are not counted), with
    what ``text_kernel_check`` found. Returns the timings and the max
    error."""
    k, d, b = TEXT_SHAPE
    u = held.pop("u")
    del held["got"]
    gc.collect()
    torch.cuda.empty_cache()
    kern = time_ms(lambda: trimmed.trimmed_mean_cuda(u, b), reps=10)
    plain = time_ms(lambda: trimmed.trimmed_mean_plain(u, b), reps=2, warmup=1)
    lib = time_ms(lambda: torch.sort(u, 0)[0][b:k - b].mean(0), reps=2, warmup=1)
    bnd, by = bound_ms(k, d)
    timings = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
    # the same shape without ties, made on the card: what ALIE's ties cost
    g = torch.Generator(device=u.device).manual_seed(0)
    untied = torch.randn(k, d, device=u.device, generator=g) * 1e-2
    untied_ms = time_ms(lambda: trimmed.trimmed_mean_cuda(untied, b), reps=5)
    got, width, untied_bad = trimmed.trimmed_mean_cuda(untied, b), -(-d // TEXT_KERNEL_SLICES), 0
    for lo in range(0, d, width):
        ref = trimmed.trimmed_mean_plain(untied[:, lo:lo + width], b)
        untied_bad += int((~torch.isclose(got[lo:lo + width], ref, **TOL)).sum())
    del untied, got, ref
    emit({"phase": "text_kernel", "shape_kdb": [k, d, b], "elements": k * d,
          "kernel_vs_plain_max_abs_err": held["err"], "entries_outside_tol": held["bad"],
          "tol": TOL, "slices": TEXT_KERNEL_SLICES, "alie_tied_columns": held["ties"],
          "last_column_max_abs": held["tail"],
          "round_applied_this_aggregate": held["applied"], **timings,
          "share_of_bound": bnd / kern, "untied_matrix_ms": untied_ms,
          "untied_entries_outside_tol": untied_bad,
          "profiler_ms": profiled_kernel_ms(torch, lambda: trimmed.trimmed_mean_cuda(u, b),
                                            reps=5),
          "tile_rows": trimmed.kernel_tile_rows(k), "card": card})
    check(held["bad"] == 0, f"text_kernel: {held['bad']} entries differ from the plain version "
          f"(max {held['err']})")
    check(held["applied"], "text_kernel: the round applied another aggregate")
    check(untied_bad == 0, f"text_kernel: {untied_bad} untied entries differ")
    del u
    gc.collect()
    torch.cuda.empty_cache()
    return timings, held["err"]


def phase_text_block(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """TEXT_BLOCK_ROUNDS bf16 rounds of the text_round configuration (in
    TEXT_BLOCK_CHUNKS client chunks) one by one and as one block
    (``run_block``; a captured CUDA graph where ``graph_block_reason`` is
    None), cuDNN's deterministic algorithms on,
    held bit for bit. Should they differ, the rounds run a second time: if
    the eager rounds differ between the two runs, the round is not
    deterministic on the card and that is recorded; otherwise the phase
    fails. Returns the block's launches."""
    b = TEXT_SHAPE[2]
    block_kw = dict(model="text_cct_2", byzantine=b, aggregator_kws={"num_byzantine": b},
                    chunks=TEXT_BLOCK_CHUNKS, warm_block=False)
    blocks = [engine_blocks(torch, trimmed, fl, log_root, "text_block", TEXT_BLOCK_ROUNDS,
                            **block_kw)]
    if blocks[0]["differs"]:
        del blocks[0]["engine"]
        blocks.append(engine_blocks(torch, trimmed, fl, log_root, "text_block_again",
                                    TEXT_BLOCK_ROUNDS, **block_kw))
    first = blocks[0]
    eager_repeats = (None if len(blocks) == 1 else
                     not _states_differ(torch, first["seq_state"], blocks[1]["seq_state"]))
    rec = {"phase": "text_block", "model": "text_cct_2", "dtype": "bfloat16",
           "client_chunks": TEXT_BLOCK_CHUNKS, "block_mode": first["mode"], "block_reason": first["reason"],
           "block_differs": first["differs"][:10], "round_s": first["round_s"],
           "block_s": first["block_s"], "block_launches": first["launches"],
           "block_capture_s": first["capture_s"], "block_warmup_s": first["warmup_s"],
           "seq_peak_bytes": first["seq_peak"], "block_peak_bytes": first["peak"],
           "eager_rounds_repeat": eager_repeats, "card": card}
    if eager_repeats is False:
        rec["block_note"] = ("the eager rounds differ between two runs with cuDNN's "
                             "deterministic algorithms: the round is not deterministic on "
                             "the card, so the block cannot be held bit for bit")
    emit(rec)
    check(first["mode"] == "graph" or first["reason"],
          f"text block ran {first['mode']} without a reason")
    check(not first["differs"] or eager_repeats is False,
          f"text block differs from its rounds: {first['differs'][:5]}")
    check(first["launches"] == TEXT_BLOCK_ROUNDS,
          f"text block: {first['launches']} launches in {TEXT_BLOCK_ROUNDS} rounds")
    return first["launches"]


def phase_text_stream(torch, trimmed, fl, card: str, log_root: Path) -> int:
    """``text_cct_2`` at TEXT_STREAM_CLIENTS clients, the streaming round in
    TEXT_STREAM_CHUNKS chunks (one [chunk, D] slab at a time: the dense
    [1000, 30352643] matrix would be 121 GB), sign flipping f=100 and the
    median, bf16, TEXT_STREAM_ROUNDS rounds. Returns the kernel's launches
    (0)."""
    run = baseline_run(torch, trimmed, fl, log_root, "text_stream", "text_cct_2",
                       TEXT_STREAM_ROUNDS, TEXT_STREAM_CHUNKS, "bfloat16",
                       attack="signflipping", byzantine=TEXT_STREAM_BYZANTINE,
                       aggregator="median", streaming=True)
    emit({"phase": "text_stream", "model": "text_cct_2", "dtype": "bfloat16",
          "attack": "signflipping", "byzantine": TEXT_STREAM_BYZANTINE, "aggregator": "median",
          **baseline_record(run), "dense_matrix_bytes": run["clients"] * run["dim"] * 4,
          "card": card})
    check(run["dim"] == TEXT_SHAPE[1], f"text_stream: D = {run['dim']}")
    check(run["peak_update_bytes"] == run["chunk_size"] * run["dim"] * 4,
          f"text_stream: peak_update_bytes {run['peak_update_bytes']}")
    check(run["launches"] == 0, f"text_stream: {run['launches']} kernel launches")
    return run["launches"]


def _leaf_rel_l2(torch, a: dict, b: dict) -> dict:
    """Each leaf's relative L2 distance of ``a`` from ``b``, over the
    leaves whose norm in ``b`` is above 1e-6 of the whole gradient's (a
    leaf whose exact gradient is 0, as the seq-pool's bias, holds rounding
    alone on both backends)."""
    whole = float(torch.sqrt(sum(t.double().square().sum() for t in b.values())))
    return {n: float((a[n] - b[n]).double().norm() / b[n].double().norm())
            for n in b if float(b[n].double().norm()) > 1e-6 * whole}


def phase_text_families(torch, fl, dev, card: str) -> None:
    """Each other text family at its registry defaults (100,000 words, 64
    tokens): eval logits and the training loss's gradient (its keep-masks
    drawn once on the CPU) on TEXT_FAMILY_BATCH padded rows of the store
    (the first row made all padding), on the card and on the CPU from the
    same params. Logits within ROUND_TOL; the whole gradient within a
    relative L2 of TEXT_GRAD_REL, the largest leaf distance reported."""
    from blades_tpu_torch.models import build_fns, create_model
    from blades_tpu_torch.utils import rng

    x = fl.test_x_raw[:TEXT_FAMILY_BATCH].cpu().clone()
    x[0] = 0
    y = fl.test_y[:TEXT_FAMILY_BATCH].cpu()
    for i, name in enumerate(TEXT_FAMILIES):
        spec = build_fns(create_model(name, num_classes=2, sample_shape=(TEXT_SEQ,)), pad_id=0)
        params = spec.init(torch.Generator().manual_seed(40 + i))
        masks = rng.keep_masks(spec.noise_sites(len(x)), torch.Generator().manual_seed(50 + i))
        out = {}
        for where in ("cpu", dev):
            p = {n: t.to(where) for n, t in params.items()}
            logits = spec.eval_logits_fn(p, x.to(where))
            grads, (loss, _) = torch.func.grad_and_value(
                lambda q: spec.train_loss_fn(q, x.to(where), y.to(where),
                                             {n: m.to(where) for n, m in masks.items()}),
                has_aux=True)(p)
            out[str(where)] = (logits.detach().cpu(), {n: g.cpu() for n, g in grads.items()},
                               float(loss))
            del p, grads
        (l_cpu, g_cpu, loss_cpu), (l_gpu, g_gpu, loss_gpu) = out["cpu"], out[str(dev)]
        flat = lambda g: torch.cat([t.reshape(-1) for t in g.values()])  # noqa: E731
        rel = float((flat(g_gpu) - flat(g_cpu)).double().norm() / flat(g_cpu).double().norm())
        leaves = _leaf_rel_l2(torch, g_gpu, g_cpu)
        worst = max(leaves, key=leaves.get)
        emit({"phase": "text_families", "model": name, "dim": spec.param_count,
              "mask_sites": list(masks), "logits_max_abs_err": float((l_gpu - l_cpu).abs().max()),
              "logits_finite": bool(torch.isfinite(l_gpu).all()), "loss": [loss_cpu, loss_gpu],
              "grad_rel_l2": rel, "bar": TEXT_GRAD_REL, "worst_leaf": [worst, leaves[worst]],
              "card": card})
        check(bool(torch.isfinite(l_gpu).all()), f"{name}: non-finite logits on the card")
        check(torch.allclose(l_gpu, l_cpu, **ROUND_TOL), f"{name}: logits differ")
        check(math.isclose(loss_gpu, loss_cpu, rel_tol=ROUND_TOL["rtol"]), f"{name}: loss")
        check(rel <= TEXT_GRAD_REL, f"{name}: gradients {rel} apart")
        del out, g_cpu, g_gpu
        gc.collect()


def text_cpu_inputs(torch):
    """``text_card_vs_cpu``'s inputs, made alike in its CPU process and on
    the card: ``text_cct_2``'s spec and params (seed 61), the first
    TEXT_CPU_CLIENTS clients' batches of one round (1 step of batch 32) of
    the K=100 text store of :func:`text_stores` built on the CPU and
    sampled with a CPU generator (seed 62), and the keep-masks (seed 63)."""
    from blades_tpu_torch.datasets import SyntheticText
    from blades_tpu_torch.models import build_fns, create_model
    from blades_tpu_torch.utils import rng

    k = TEXT_CPU_CLIENTS
    spec = build_fns(create_model("text_cct_2", num_classes=2, sample_shape=(TEXT_SEQ,)),
                     pad_id=0)
    params = spec.init(torch.Generator().manual_seed(61))
    fl = SyntheticText(vocab_size=TEXT_VOCAB, seq_len=TEXT_SEQ, min_len=TEXT_MIN_LEN,
                       train_size=TEXT_TRAIN, test_size=TEXT_TEST, num_clients=TEXT_SHAPE[0],
                       train_bs=32, seed=0, cache=False).get_dls("cpu")
    cx, cy = fl.sample_round(torch.Generator().manual_seed(62), 1, 32)
    masks = rng.keep_masks(spec.noise_sites(32), torch.Generator().manual_seed(63), (k,))
    return spec, params, cx[:k].clone(), cy[:k].clone(), masks


def text_round_on(torch, spec, params, cx, cy, masks, where) -> tuple:
    """One ALIE + trimmed-mean round (f = b = TEXT_CPU_BYZANTINE) of
    ``text_cct_2`` at K=TEXT_CPU_CLIENTS on ``where``, the keep-masks
    ``masks`` handed to the engine: the updates, the aggregate the round
    applied and the new flat params on the CPU, and the round's wall."""
    from blades_tpu_torch.aggregators import Trimmedmean
    from blades_tpu_torch.attackers import Alie
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.ops.pytree import ravel
    from blades_tpu_torch.utils import rng

    k, f = TEXT_CPU_CLIENTS, TEXT_CPU_BYZANTINE
    drawn = rng.keep_masks

    def same_masks(sites, generator, lead=()):
        check(list(sites) == list(masks) and tuple(lead) == (k,), f"mask sites {list(sites)}")
        return {n: m.to(generator.device) for n, m in masks.items()}

    rng.keep_masks = same_masks
    try:
        eng = RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, params, spec.layout,
                          num_clients=k, num_byzantine=f,
                          attack=Alie(num_clients=k, num_byzantine=f),
                          aggregator=Trimmedmean(num_byzantine=f), device=where,
                          noise_sites=spec.noise_sites)
        t0 = time.perf_counter()
        state, _ = eng.run_round(eng.init(params), cx.to(where), cy.to(where), 0.1, 1.0)
        agg, _ = eng.aggregator.aggregate(eng.last_updates)  # what the round applied
        out = (eng.last_updates.cpu(), agg.cpu(), ravel(state.params, spec.layout).cpu())
        return (*out, time.perf_counter() - t0)
    finally:
        rng.keep_masks = drawn


def text_cpu(out_path: str) -> int:
    """``--text-cpu OUT``: ``text_card_vs_cpu``'s CPU round (its inputs,
    the round's updates, aggregate, new params and wall) into OUT, with
    TEXT_CPU_THREADS torch threads (run as a subprocess of the card run)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.set_num_threads(TEXT_CPU_THREADS)
    spec, params, cx, cy, masks = text_cpu_inputs(torch)
    u, a, p, secs = text_round_on(torch, spec, params, cx, cy, masks, "cpu")
    torch.save({"cx": cx, "cy": cy, "masks": masks, "updates": u, "agg": a, "params": p,
                "round_s": secs}, out_path)
    return 0


def start_text_cpu(log_root: Path) -> tuple:
    """Start ``--text-cpu`` in a subprocess (killed at exit should a phase
    fail before it is collected)."""
    import atexit

    out = log_root / "text_cpu" / "round.pt"
    out.parent.mkdir(parents=True)
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--text-cpu",
                             str(out)], stdout=log, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)
    return proc, out, log


def phase_text_card_vs_cpu(torch, cpu_run: tuple, dev, card: str) -> None:
    """One ``text_cct_2`` round at full width and K=TEXT_CPU_CLIENTS (ALIE
    and trimmed mean with f = b = TEXT_CPU_BYZANTINE, 1 step of batch 32)
    on the card and on the CPU (``cpu_run``, the :func:`start_text_cpu`
    process's) from the same params, the same batches and the same
    keep-masks (:func:`text_cpu_inputs`, checked equal to the CPU
    process's). The aggregate and the new params within ROUND_TOL; every
    update row within ROUND_TOL but for at most TEXT_MAX_KINK_ROWS, which
    are reported."""
    k, f = TEXT_CPU_CLIENTS, TEXT_CPU_BYZANTINE
    spec, params, cx, cy, masks = text_cpu_inputs(torch)
    u_gpu, a_gpu, p_gpu, gpu_s = text_round_on(torch, spec, params, cx, cy, masks, dev)
    proc, path, log = cpu_run
    t0 = time.perf_counter()
    rc = proc.wait(timeout=900)
    wait_s = time.perf_counter() - t0
    log.close()
    check(rc == 0, "the text CPU round failed:\n" + path.with_suffix(".log").read_text()[-3000:])
    ref = torch.load(path)
    check(torch.equal(ref["cx"], cx) and torch.equal(ref["cy"], cy)
          and all(torch.equal(ref["masks"][n], m) for n, m in masks.items()),
          "text_card_vs_cpu: the CPU process's inputs differ from the card's")
    u_cpu, a_cpu, p_cpu = ref["updates"], ref["agg"], ref["params"]
    row_ok = torch.isclose(u_gpu, u_cpu, **ROUND_TOL).all(dim=1)
    emit({"phase": "text_card_vs_cpu", "model": "text_cct_2", "clients": k, "byzantine": f,
          "b": f, "dim": u_cpu.shape[1], "tol": ROUND_TOL, "mask_sites": list(masks),
          "pad_share": float((cx == 0).float().mean()),
          "updates_max_abs_err": float((u_gpu - u_cpu).abs().max()),
          "updates_max_abs": float(u_cpu.abs().max()),
          "update_rows_outside_tol": torch.nonzero(~row_ok).flatten().tolist(),
          "agg_max_abs_err": float((a_gpu - a_cpu).abs().max()),
          "params_max_abs_err": float((p_gpu - p_cpu).abs().max()),
          "round_s": {"cpu": ref["round_s"], str(dev): gpu_s}, "cpu_threads": TEXT_CPU_THREADS,
          "waited_for_cpu_s": wait_s, "card": card})
    check(int((~row_ok).sum()) <= TEXT_MAX_KINK_ROWS,
          f"{int((~row_ok).sum())} text update rows differ (allowed {TEXT_MAX_KINK_ROWS})")
    check(torch.allclose(a_gpu, a_cpu, **ROUND_TOL), "text aggregates differ")
    check(torch.allclose(p_gpu, p_cpu, **ROUND_TOL), "text new params differ")


def phase_pretrained(torch, dev, card: str, weights: Path) -> None:
    """The pretrained path with no network and no real weights: a
    reference-named state dict of ``cct_7_3x1_32`` (the port's params from
    a seed, through ``import_torch.to_reference_state_dict``) saved under a
    temporary ``BLADES_TPU_WEIGHTS``, loaded with ``BLADES_TPU_OFFLINE=1``
    through ``create_model("cct_7_3x1_32", pretrained=True)``: the loaded
    params equal the written ones, and the card's logits equal the CPU's
    within ROUND_TOL."""
    import os

    from blades_tpu_torch.models import build_fns, create_model
    from blades_tpu_torch.models.import_torch import to_reference_state_dict
    from blades_tpu_torch.models.pretrained import weights_path

    saved = {k: os.environ.get(k) for k in ("BLADES_TPU_WEIGHTS", "BLADES_TPU_OFFLINE")}
    os.environ["BLADES_TPU_WEIGHTS"], os.environ["BLADES_TPU_OFFLINE"] = str(weights), "1"
    try:
        source = build_fns(create_model("cct_7_3x1_32", sample_shape=(32, 32, 3))).init(
            torch.Generator().manual_seed(71))
        weights.mkdir(parents=True, exist_ok=True)
        path = weights_path("cct_7_3x1_32")
        torch.save({"state_dict": to_reference_state_dict(source)}, path)
        t0 = time.perf_counter()
        spec = create_model("cct_7_3x1_32", sample_shape=(32, 32, 3), pretrained=True)
        params = spec.init(torch.Generator().manual_seed(0))
        load_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    same = all(torch.equal(params[n], source[n]) for n in source)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(72))
    on_cpu = spec.eval_logits_fn(params, x).detach()
    on_card = spec.eval_logits_fn({n: t.to(dev) for n, t in params.items()},
                                  x.to(dev)).detach().cpu()
    emit({"phase": "pretrained", "model": "cct_7_3x1_32", "file_bytes": os.path.getsize(path),
          "load_s": load_s, "params_equal_written": same, "dim": spec.param_count,
          "logits_max_abs_err": float((on_card - on_cpu).abs().max()), "card": card})
    check(same, "pretrained: the loaded params differ from the written checkpoint")
    check(torch.allclose(on_card, on_cpu, **ROUND_TOL), "pretrained: card and CPU logits differ")


def text_phases(torch, trimmed, dev, card: str, log_root: Path, text_cpu_run=None) -> dict:
    """The text and pretrained phases (slice 11b) in order: the stores, the
    K=100 round and its kernel, the graph block (cuDNN deterministic), the
    K=1000 streaming round, the f32 round with and without remat (slice
    2b), the other families and the round on the card against the CPU
    (whose CPU half runs in the process ``text_cpu_run``, started here when
    None), the pretrained loader. Returns the kernel's launches
    by path, the kernel's timings at TEXT_SHAPE and its max error."""
    text_cpu_run = text_cpu_run or start_text_cpu(log_root)
    stores = text_stores(torch, dev)
    launches, timings, err = phase_text_round(torch, trimmed, stores["k100"], card, log_root)
    with deterministic_cudnn():
        block = phase_text_block(torch, trimmed, stores["k100"], card, log_root)
    stream = phase_text_stream(torch, trimmed, stores["k1000"], card, log_root)
    # remat (slice 2b) on the f32 round at one chunk: after the streaming
    # round, whose median sort needed the allocator as the block left it
    # (ahead of the block, the remat runs left 12.7 GB reserved and unused,
    # and the sort's 22.6 GB did not fit)
    with deterministic_cudnn():
        phase_remat_text(torch, stores["k100"], card, log_root)
    phase_text_families(torch, stores["k100"], dev, card)
    del stores
    phase_text_card_vs_cpu(torch, text_cpu_run, dev, card)
    phase_pretrained(torch, dev, card, log_root / "weights")
    return dict(launches=launches, block=block, stream=stream, timings=timings, err=err)


# -- the run's records (slice 10b) ------------------------------------------------


def _strip_times(rec: dict) -> dict:
    """A ``timeline`` or ``round`` record without its times (and the memory
    gauges, which depend on the allocator), so two runs' records compare."""
    times = ("enqueue_s", "ready_s", "dispatch_share", "compile_s", "wall_s", "ts", "run_id",
             "attempt")
    out = {n: v for n, v in rec.items() if n not in times}
    if "gauges" in out:
        out["gauges"] = {n: v for n, v in out["gauges"].items()
                         if not n.startswith(("mem.", "heartbeat."))}
    return out


def phase_run_records(torch, trimmed, fl, card: str, log_root: Path) -> dict:
    """The run's own records on the main path (cuDNN deterministic): the
    bf16 CCT-2 round at K=1000 (ALIE f=5, trimmed mean b=5) through
    Simulator.run, RECORDS_ROUNDS rounds with the ledger, alerts, timeline
    and heartbeat on (``BLADES_LEDGER`` and ``BLADES_HEARTBEAT_FILE`` in
    the run's temporary directory), then the same rounds with
    ``BLADES_TELEMETRY=0``: one started and one finished ledger record, one
    ``timeline`` record a round, the heartbeat at the last round with
    ``interval_s`` near that round's wall, no alert, every record valid,
    and the run's host syncs the same on and off. Then a graph block of
    RECORDS_BLOCK rounds: captured once (its ``timeline`` record counts the
    capture), replayed from an ``EngineCache`` hit with the records on and
    off (the same host syncs), and run as an eager block: the replayed
    block's ``timeline`` and ``round`` records equal the eager block's in
    every field but times. Last, the MLP at K=10 with client learning rate
    NAN_CLIENT_LR: its loss goes non-finite, a critical ``loss_nonfinite``
    alert is recorded and the alert file written."""
    import os

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.core.engine import RoundEngine
    from blades_tpu_torch.datasets import Synthetic
    from blades_tpu_torch.supervision import heartbeat
    from blades_tpu_torch.sweeps import EngineCache
    from blades_tpu_torch.telemetry import alerts, ledger, schema

    base = log_root / "run_records"
    base.mkdir()
    env = {ledger.LEDGER_ENV: str(base / "ledger.jsonl"),
           heartbeat.HEARTBEAT_ENV: str(base / "heartbeat.json"),
           alerts.ALERT_FILE_ENV: str(base / "alert.json")}
    saved = {n: os.environ.get(n) for n in (*env, "BLADES_TELEMETRY")}
    os.environ.update(env)
    run = dict(model="cct_2_3x2_32", local_steps=1, server_lr=1.0, client_lr=0.1,
               client_chunks=CCT2_CHUNKS, compute_dtype="bfloat16")

    def one(name, rounds, telemetry=True, **kw):
        os.environ["BLADES_TELEMETRY"] = "1" if telemetry else "0"
        gc.collect()
        torch.cuda.empty_cache()
        sim = forensics_sim(fl, base, name)
        out = {}
        trimmed.trimmed_mean_launches = 0
        sites = host_syncs(torch, lambda: out.update(times=sim.run(
            global_rounds=rounds, validate_interval=rounds + 1, **run, **kw)))
        torch.cuda.synchronize()
        recs = forensics_records(base / name) if telemetry else {"errors": [], "by_type": {}}
        return dict(sim=sim, round_s=out["times"], syncs=sum(sites.values()), sites=sites,
                    launches=trimmed.trimmed_mean_launches, recs=recs)

    def ledger_events():
        return [r["event"] for r in ledger.read_ledger(env[ledger.LEDGER_ENV])]

    out = {}
    try:
        on = one("records_on", RECORDS_ROUNDS)
        check(ledger_events() == ["started", "finished"], f"run_records: ledger {ledger_events()}")
        led = ledger.read_ledger(env[ledger.LEDGER_ENV])
        beat = heartbeat.read(env[heartbeat.HEARTBEAT_ENV])
        tl = on["recs"]["by_type"].get("timeline", [])
        errors = (on["recs"]["errors"] + schema.validate_records(led)
                  + schema.validate_records([beat]))
        check(errors == [], f"run_records: schema errors {errors[:5]}")
        check([r["round"] for r in tl] == list(range(1, RECORDS_ROUNDS + 1))
              and all(r["kind"] == "round" for r in tl), f"run_records: timeline {tl}")
        check(not on["recs"]["by_type"].get("alert"), "run_records: an alert on a healthy run")
        last_wall = on["round_s"][-1]
        check(beat["round"] == RECORDS_ROUNDS
              and abs(beat["interval_s"] - last_wall) <= 0.25 * last_wall + 0.02,
              f"run_records: heartbeat {beat} against the last round's {last_wall} s")
        check(on["launches"] == RECORDS_ROUNDS, f"run_records: launches {on['launches']}")
        off = one("records_off", RECORDS_ROUNDS, telemetry=False)
        check(not (base / "records_off" / "telemetry.jsonl").exists(),
              "run_records: a trace with BLADES_TELEMETRY=0")
        check(on["syncs"] == off["syncs"], f"run_records: host syncs on {on['sites']} "
              f"off {off['sites']}")
        check(ledger_events() == ["started", "finished"] * 2, f"ledger {ledger_events()}")

        # a graph block: captured, then replayed from the cache on and off
        cache = EngineCache()
        blk = dict(block_size=RECORDS_BLOCK, engine_cache=cache)
        cold = one("block_capture", RECORDS_BLOCK, **blk)
        graph = one("block_graph", RECORDS_BLOCK, **blk)
        graph_off = one("block_graph_off", RECORDS_BLOCK, telemetry=False, **blk)
        modes = [r["sim"].engine.last_block_mode for r in (cold, graph, graph_off)]
        check(modes == ["graph"] * 3 and cache.hits == 2, f"run_records: blocks {modes}, "
              f"cache hits {cache.hits}")
        check(graph["syncs"] == graph_off["syncs"], f"run_records: block host syncs on "
              f"{graph['sites']} off {graph_off['sites']}")
        cold_tl = cold["recs"]["by_type"]["timeline"]
        check(cold_tl[0].get("compiles", 0) >= 1 and "compiles" not in
              graph["recs"]["by_type"]["timeline"][0],
              f"run_records: capture counts {cold_tl} {graph['recs']['by_type']['timeline']}")
        reason = RoundEngine.graph_block_reason
        RoundEngine.graph_block_reason = lambda self: "eager on purpose (chip_smoke run_records)"
        try:
            eager = one("block_eager", RECORDS_BLOCK, block_size=RECORDS_BLOCK)
        finally:
            RoundEngine.graph_block_reason = reason
        check(eager["sim"].engine.last_block_mode == "eager", "run_records: eager block")
        differ = {}
        for t in ("timeline", "round"):
            a = [_strip_times(r) for r in graph["recs"]["by_type"][t]]
            b = [_strip_times(r) for r in eager["recs"]["by_type"][t]]
            if a != b:
                differ[t] = {"graph": a, "eager": b}
        check(not differ, f"run_records: graph block records differ from eager: {differ}")

        # a loss that goes non-finite: the critical alert and its file
        os.environ["BLADES_TELEMETRY"] = "1"
        ds = Synthetic(num_clients=NAN_CLIENTS, train_size=200, test_size=40, cache=False)
        sim = Simulator(ds, aggregator="mean", seed=0, device=fl.device,
                        log_path=str(base / "nan"))
        sim.run("mlp", global_rounds=3, train_batch_size=8, client_lr=NAN_CLIENT_LR,
                validate_interval=99)
        nan = forensics_records(base / "nan")
        losses = [r["train_loss"] for r in nan["by_type"]["round"]]
        fired = nan["by_type"].get("alert", [])
        body = json.loads((base / "alert.json").read_text())
        check(not all(map(math.isfinite, losses)) and len(fired) == 1
              and fired[0]["rule"] == "loss_nonfinite" and fired[0]["severity"] == "critical"
              and body["rule"] == "loss_nonfinite" and nan["errors"] == [],
              f"run_records: nan losses {losses}, alerts {fired}, schema {nan['errors']}")
        out = {"cct2_bf16_run_records": on["launches"],
               "cct2_bf16_run_records_block": graph["launches"]}
        emit({"phase": "run_records", "rounds": RECORDS_ROUNDS,
              "round_s_records_on": on["round_s"], "round_s_records_off": off["round_s"],
              "host_syncs_run_on": on["syncs"], "host_syncs_run_off": off["syncs"],
              "host_sync_sites": on["sites"], "ledger": led, "heartbeat": beat,
              "timeline": tl, "block_round_s": graph["round_s"],
              "block_round_s_off": graph_off["round_s"], "block_eager_round_s": eager["round_s"],
              "block_host_syncs_on": graph["syncs"], "block_host_syncs_off": graph_off["syncs"],
              "block_timeline": graph["recs"]["by_type"]["timeline"],
              "capture_timeline": cold_tl, "nan_losses": [repr(x) for x in losses],
              "nan_alert": fired[0], "launches": out, "card": card})
        del on, off, cold, graph, graph_off, eager, sim
    finally:
        for n, v in saved.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
    return out


# -- defense certification (slice 10b) --------------------------------------------


def cpu_certify(out_path: str) -> int:
    """``--cpu-certify OUT``: the certify script's default configuration on
    the CPU, every cell's search result and the matrix, as JSON in OUT (the
    card phase's reference; run as a subprocess of the card run)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from blades_tpu_torch.examples import certify

    torch.set_num_threads(CERT_CPU_THREADS)
    args = certify.parse_args([*CERT_ARGS, "--device", "cpu",
                               "--out", str(Path(out_path).parent)])
    t0 = time.perf_counter()
    plans, specs = certify.enumerate_cells(args, "cpu")
    results, walls, report = certify.execute_cells(args, plans, specs)
    matrix = certify.assemble_matrix(args, plans, specs, results, walls, report, "cpu")
    with open(out_path, "w") as fh:
        json.dump({"labels": [s.label for s in specs], "results": results, "matrix": matrix,
                   "wall_s": time.perf_counter() - t0}, fh)
    return 0


def start_cpu_certify(log_root: Path) -> tuple:
    """Start the certify phase's CPU reference, ``--cpu-certify`` in a
    subprocess (killed at exit should a phase fail before it is
    collected). The whole script starts it beside the kernel's build, so
    that it ends before the certify phase's card runs, which are host-bound
    (run to its end at the phase's start, it took 38 s of the script), and
    before the text phases' CPU round."""
    import atexit

    out = log_root / "certify_cpu" / "raw.json"
    out.parent.mkdir(parents=True)
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--cpu-certify",
                             str(out)], stdout=log, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)
    return proc, out, log


def finish_cpu_certify(handle: tuple) -> dict:
    """Wait for the CPU reference; returns what it wrote."""
    proc, out, log = handle
    rc = proc.wait(timeout=900)
    log.close()
    check(rc == 0, "the CPU certify run failed:\n"
          + out.with_suffix(".log").read_text()[-3000:])
    return json.loads(out.read_text())


def certify_expected_launches(specs, k: int, trials: int, grids: dict) -> tuple:
    """The kernel launches a certify run must make: each trimmed-mean search
    evaluation without a participation mask and with 1 <= b <= 16 (and
    K - 2b > 0), and the battery's 4 defense calls (permutation and
    translation, 2 each) of such a trimmed mean."""
    from blades_tpu_torch.aggregators import Trimmedmean
    from blades_tpu_torch.ops.trimmed import MAX_KERNEL_B

    per_item = (len(grids["ipm_eps"]) + len(grids["alie_z"]) + len(grids["signflip_s"]) + 6)
    search = battery = 0
    for spec in specs:
        if not isinstance(spec.agg, Trimmedmean):
            continue
        b = spec.agg._effective_b(k)
        if not (1 <= b <= MAX_KERNEL_B and k - 2 * b > 0):
            continue
        if spec.part_mask is None:
            search += trials * per_item
        if spec.label.startswith("battery/"):
            battery += 4
    return search, battery


def certify_on_card(torch, trimmed, certify, dev, out_dir: Path, count: bool,
                    aggs: tuple = ()) -> dict:
    """One run of the certify script's ``main`` on the card in the certify
    phase's configuration (CERT_ARGS; cut to ``aggs`` where given), the
    matrix into
    ``out_dir``: its wall, kernel launches, summary line, matrix, cells and
    results. With ``count`` it also counts the host syncs (sync debug
    mode, which slows the host: that run's wall is not the script's) and
    keeps every kernel launch's input, b and output (``seen``)."""
    import contextlib
    import io

    kept, seen = {}, []
    orig_enum, orig_exec = certify.enumerate_cells, certify.execute_cells
    orig_kernel = trimmed.trimmed_mean_cuda

    def enumerate_cells(*a, **kw):
        kept["plans"], kept["specs"] = orig_enum(*a, **kw)
        return kept["plans"], kept["specs"]

    def execute_cells(*a, **kw):
        out = orig_exec(*a, **kw)
        kept["results"], kept["walls"] = out[:2]
        return out

    def kernel(x, b):
        out = orig_kernel(x, b)
        seen.append((x.clone(), b, out.clone()))
        return out

    def run():
        kept["rc"] = certify.main([*CERT_ARGS, "--device", str(dev), "--out", str(out_dir),
                                   *(("--aggs", *aggs) if aggs else ())])

    certify.enumerate_cells, certify.execute_cells = enumerate_cells, execute_cells
    if count:
        trimmed.trimmed_mean_cuda = kernel
    buf = io.StringIO()
    sites = None
    torch.cuda.synchronize()
    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            if count:
                sites = host_syncs(torch, run)
            else:
                run()
        torch.cuda.synchronize()
    finally:
        certify.enumerate_cells, certify.execute_cells = orig_enum, orig_exec
        trimmed.trimmed_mean_cuda = orig_kernel
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    check(kept["rc"] == 0 and summary["ok"] and len(lines) == 1,
          f"certify on the card: rc {kept['rc']}, {lines}")
    return dict(kept, wall=wall, launches=trimmed.trimmed_mean_launches, summary=summary,
                matrix=json.loads((out_dir / "cert_matrix.json").read_text()), sites=sites,
                seen=seen, aggs=aggs)


def certify_differences(run: dict, ref: dict) -> tuple:
    """A card run's departures from the CPU run: the matrix and async cells
    whose verdict differs, the battery contracts whose verdict differs, and
    the cells whose worst ratio (overall or a template's) is off CERT_TOL."""
    import numpy as np

    from blades_tpu_torch.audit import TEMPLATE_NAMES

    labels = [s.label for s in run["specs"]]
    ref_by = dict(zip(ref["labels"], ref["results"]))
    aggs = run["aggs"]
    # a run cut to ``aggs`` has the CPU run's cells of those defenses
    want = [lab for lab in ref["labels"] if not aggs
            or lab.removeprefix("battery/").split("/")[0] in aggs]
    check(labels == want, "certify: the CPU run enumerated other cells")
    ratios = []
    for lab, got in zip(labels, run["results"]):
        want = ref_by[lab]
        pairs = [("worst_ratio", got["worst_ratio"], want["worst_ratio"])]
        pairs += [(f"{n}.worst_ratio", got["templates"][n]["worst_ratio"],
                   want["templates"][n]["worst_ratio"]) for n in TEMPLATE_NAMES]
        ratios += [{"cell": lab, "field": t, "card": a, "cpu": b}
                   for t, a, b in pairs if not np.isclose(a, b, **CERT_TOL)]
    matrix, ref_matrix = run["matrix"], ref["matrix"]
    rows = {(r["agg"], r["f"], r.get("scenario")): r["certified"]
            for r in matrix["cells"] + matrix["async_cells"]}
    ref_rows = {(r["agg"], r["f"], r.get("scenario")): r["certified"]
                for r in ref_matrix["cells"] + ref_matrix["async_cells"]}
    verdicts = [list(key) for key in rows if rows[key] != ref_rows.get(key)]
    battery = [[n, c] for n, e in matrix["battery"].items() for c, r in e["contracts"].items()
               if r["ok"] != ref_matrix["battery"][n]["contracts"][c]["ok"]]
    return verdicts, battery, ratios


def certify_kernel_shapes(torch, trimmed, seen: list, card: str) -> tuple:
    """Every kernel launch of a certify run held against the plain version
    on its own input (the search's attacked [8, 32] matrices and the
    battery's), grouped by [K, D, b]; then each shape's kernel timed on its
    first input beside its bound, the plain version and torch.sort + slice
    + mean. Returns ``{(k, d, b): timings}`` and the largest error."""
    groups = {}
    for x, b, out in seen:
        groups.setdefault((*x.shape, b), []).append((x, out))
    shapes, max_err = {}, 0.0
    for (k, d, b), items in sorted(groups.items()):
        xs = torch.stack([x for x, _ in items])  # [N, K, D]
        got = torch.stack([out for _, out in items])
        ref = trimmed.trimmed_mean_plain(xs.transpose(0, 1).reshape(k, -1), b).reshape(-1, d)
        err = float((got - ref).abs().max())
        ok = bool(torch.allclose(got, ref, **TOL))
        x = items[0][0]
        kern = time_ms(lambda: trimmed.trimmed_mean_cuda(x, b), reps=20)
        plain = time_ms(lambda: trimmed.trimmed_mean_plain(x, b), reps=20)
        lib = time_ms(lambda: torch.sort(x, 0)[0][b:k - b].mean(0), reps=20)
        bnd, by = bound_ms(k, d)
        shapes[(k, d, b)] = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                 bound_by=by)
        emit({"phase": "certify_kernel", "shape_kdb": [k, d, b], "launches_compared": len(items),
              "max_abs_err": err, "ok": ok, **shapes[(k, d, b)], "card": card})
        check(ok, f"certify: the kernel at [{k}, {d}], b={b} differs from its plain version "
              f"by {err} on the search's own inputs")
        max_err = max(max_err, err)
    return shapes, max_err


def phase_certify(torch, trimmed, dev, card: str, log_root: Path, cpu_run: tuple) -> tuple:
    """The certify script (``blades_tpu_torch/examples/certify.py``) on the
    card through its ``main``, in its committed configuration less the
    staleness columns (CERT_ARGS), the matrix
    into the run's temporary directory, against the same run on the CPU
    (``cpu_run``: a subprocess started before the text phases, ended by
    now): ``ok`` (the headline expectations
    hold), every cell's verdict equal to the CPU run's and its worst ratio
    at CERT_TOL (each template's too), every battery verdict equal, and the
    kernel's launches equal to the trimmed-mean evaluations the plan makes
    with 1 <= b <= 16 and no mask. The timed run is alone on the machine
    with the sync debug mode off; a second run counts its host syncs and
    keeps every launch's input, and each launch is then held against the
    plain version (``certify_kernel_shapes``); it is cut to
    CERT_COUNTED_AGGS, which makes every launch. Returns the timed run's
    launches, the timings at each [K, D, b], the kernel's largest error and
    the timed run (``resilient_certify``'s reference)."""
    from blades_tpu_torch.audit import DEFAULT_GRIDS
    from blades_tpu_torch.examples import certify

    ref = finish_cpu_certify(cpu_run)
    timed = certify_on_card(torch, trimmed, certify, dev, log_root / "certify", count=False)
    counted = certify_on_card(torch, trimmed, certify, dev, log_root / "certify_counted",
                              count=True, aggs=CERT_COUNTED_AGGS)
    args = certify.parse_args(list(CERT_ARGS))
    search, battery = certify_expected_launches(timed["specs"], args.clients, args.trials,
                                                DEFAULT_GRIDS)
    for name, run in (("timed", timed), ("counted", counted)):
        check(run["launches"] == search + battery, f"certify ({name} run): {run['launches']} "
              f"launches, the plan makes {search} + {battery}")
    check(len(counted["seen"]) == counted["launches"], "certify: a launch was not kept")
    differ = {name: certify_differences(run, ref) for name, run in (("timed", timed),
                                                                    ("counted", counted))}
    sites = counted["sites"]
    n_cells = len(timed["specs"])
    summary = timed["summary"]
    emit({"phase": "certify", "ok": summary["ok"], "cells": n_cells,
          "matrix_cells": summary["cells"], "async_cells": summary["async_cells"],
          "certified_cells": summary["certified_cells"], "wall_s": timed["wall"],
          "wall_s_per_cell": timed["wall"] / n_cells, "search_s": sum(timed["walls"]),
          "wall_s_counted_run": counted["wall"],
          "counted_aggs": CERT_COUNTED_AGGS, "host_syncs": sum(sites.values()),
          "host_syncs_per_cell": sum(sites.values()) / len(counted["specs"]),
          "host_sync_sites": dict(sorted(sites.items(), key=lambda kv: -kv[1])[:12]),
          "launches": timed["launches"], "launches_planned_search": search,
          "launches_planned_battery": battery, "cpu_wall_s": ref["wall_s"],
          "cpu_threads": CERT_CPU_THREADS,
          **{f"{what}_differ_{name}": d[i][:20] for name, d in differ.items()
             for i, what in enumerate(("verdicts", "battery", "ratios"))},
          "card": card})
    for name, (verdicts, battery_differ, ratios) in differ.items():
        check(not verdicts and not battery_differ, f"certify ({name} run): verdicts differ "
              f"from the CPU run: {verdicts} {battery_differ}")
        check(not ratios, f"certify ({name} run): ratios differ from the CPU run at "
              f"{CERT_TOL}: {ratios[:10]}")
    shapes, err = certify_kernel_shapes(torch, trimmed, counted["seen"], card)
    return timed["launches"], shapes, err, timed


def phase_certify_scale(torch, trimmed, dev, card: str) -> tuple:
    """One search cell each of CERT_SCALE_CELLS at K=100 and D = 283,723
    (CERT_SCALE_TRIALS trials, the default grids, sync): wall, peak memory,
    host syncs and kernel launches each (trimmed mean at f=10 launches the
    kernel once per evaluation, at f=20 it sorts). Then the kernel at that
    shape, b=10, on an ALIE-attacked trial matrix against its plain
    version, and timed beside its bound and torch.sort + slice + mean.
    Returns the f=10 cell's launches, the timings and the kernel's error."""
    from blades_tpu_torch.audit import (
        DEFAULT_GRIDS,
        battery_ctx,
        search_cell,
        synthetic_honest,
    )
    from blades_tpu_torch.audit.attack_search import alie_rows
    from blades_tpu_torch.examples.certify import build_aggregator

    k, d, b = CERT_SCALE_CLIENTS, CCT2_SHAPE[1], CERT_SCALE_B
    g = DEFAULT_GRIDS
    per_item = len(g["ipm_eps"]) + len(g["alie_z"]) + len(g["signflip_s"]) + 6
    trials = synthetic_honest(torch.Generator(device=dev).manual_seed(0), CERT_SCALE_TRIALS,
                              k, d, device=dev)
    ctx = battery_ctx(None, k, d, device=dev)
    kernel_launches = None
    for name, f in CERT_SCALE_CELLS:
        agg = build_aggregator(name, k, f)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trimmed.trimmed_mean_launches = 0
        res = {}
        # the first call counts host syncs (sync debug mode slows the host)
        # and the peak memory, the second is timed alone
        sites = host_syncs(torch, lambda: res.update(search_cell(agg, trials, f, ctx=ctx,
                                                                 grids=g)))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = trimmed.trimmed_mean_launches
        t0 = time.perf_counter()
        search_cell(agg, trials, f, ctx=ctx, grids=g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kernel = name == "trimmedmean" and 1 <= agg._effective_b(k) <= 16
        expect = CERT_SCALE_TRIALS * per_item if kernel else 0
        emit({"phase": "certify_scale", "cell": f"{name}/f{f}", "k": k, "d": d,
              "trials": CERT_SCALE_TRIALS, "wall_s": wall,
              "evaluations": CERT_SCALE_TRIALS * per_item, "peak_extra_bytes": peak,
              "host_syncs": sum(sites.values()), "host_sync_sites": sites,
              "launches": launches, "worst_ratio": res["worst_ratio"],
              "templates": {t: v["worst_ratio"] for t, v in res["templates"].items()},
              "rho": res["rho"], "card": card})
        check(launches == expect and trimmed.trimmed_mean_launches == 2 * expect,
              f"certify_scale {name}/f{f}: {launches} launches, then "
              f"{trimmed.trimmed_mean_launches - launches}, expected {expect} each")
        check(math.isfinite(res["worst_ratio"]) and res["rho"] > 0,
              f"certify_scale {name}/f{f}: {res}")
        if kernel:
            kernel_launches = launches
    # the kernel at this shape, on an attacked trial matrix
    byz = torch.arange(k, device=dev) < b
    x = alie_rows(trials[0], byz, torch.tensor(1.0, device=dev)).contiguous()
    del trials
    got = trimmed.trimmed_mean_cuda(x, b)
    ref = trimmed.trimmed_mean_plain(x, b)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, **TOL))
    kern = time_ms(lambda: trimmed.trimmed_mean_cuda(x, b), reps=20)
    plain = time_ms(lambda: trimmed.trimmed_mean_plain(x, b), reps=3, warmup=1)
    lib = time_ms(lambda: torch.sort(x, 0)[0][b:k - b].mean(0), reps=5, warmup=1)
    bnd, by = bound_ms(k, d)
    timings = dict(ms=kern, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
    emit({"phase": "certify_scale_kernel", "shape_kdb": [k, d, b], "max_abs_err": err,
          "ok": ok, **timings, "share_of_bound": bnd / kern, "card": card})
    check(ok, f"certify_scale: kernel and plain version differ by {err}")
    return kernel_launches, timings, err



# -- ExperimentBatch(mode="vmap") and remat (slices 7b and 2b) ---------------------


class _BatchedRecorder:
    """Keeps the input, b and output of the first ``keep`` batched launches
    made outside a capture (a captured launch's buffers hold no data yet),
    while installed over ``trimmed.trimmed_mean_batched_cuda``."""

    def __init__(self, torch, trimmed, keep: int = 1):
        self.torch, self.trimmed, self.keep, self.held = torch, trimmed, keep, []
        self.real = trimmed.trimmed_mean_batched_cuda

    def __call__(self, x, b):
        out = self.real(x, b)
        if len(self.held) < self.keep and not self.torch.cuda.is_current_stream_capturing():
            self.held.append((x.clone(), b, out.clone()))
        return out

    def __enter__(self):
        self.trimmed.trimmed_mean_batched_cuda = self
        return self

    def __exit__(self, *exc):
        self.trimmed.trimmed_mean_batched_cuda = self.real


def batched_launch_check(torch, trimmed, x, b: int) -> dict:
    """One batched launch on ``[S, K, D]`` against S single launches
    (``torch.equal``: each column's arithmetic is the same) and against
    ``trimmed_mean_batched_plain`` (TOL). Not counted on any path."""
    got = trimmed.trimmed_mean_batched_cuda(x, b)
    singles = torch.stack([trimmed.trimmed_mean_cuda(u, b) for u in x])
    plain = trimmed.trimmed_mean_batched_plain(x, b)
    torch.cuda.synchronize()
    return dict(equal_to_single_launches=bool(torch.equal(got, singles)),
                max_abs_err=float((got - plain).abs().max()),
                within_tol=bool(torch.allclose(got, plain, **TOL)))


def batched_bound_ms(s: int, k: int, d: int) -> tuple:
    """:func:`bound_ms` of S slabs: S*K*D*4 bytes read and S*D*4 written, or
    the compares at the f32 rate, the larger."""
    bytes_ms = (s * k * d * 4 + s * d * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * s * k * d / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def batched_kernel_timings(torch, trimmed, x, b: int) -> dict:
    """The batched launch on ``x`` [S, K, D] timed beside S single launches,
    the batched plain version, the library call (one sort along the client
    axis, a slice and a mean) and the bound."""
    s, k, d = x.shape
    bnd, by = batched_bound_ms(s, k, d)
    return dict(ms=time_ms(lambda: trimmed.trimmed_mean_batched_cuda(x, b), reps=10),
                single_launches_ms=time_ms(
                    lambda: [trimmed.trimmed_mean_cuda(u, b) for u in x], reps=10),
                plain_ms=time_ms(lambda: trimmed.trimmed_mean_batched_plain(x, b), reps=2,
                                 warmup=1),
                library_ms=time_ms(lambda: torch.sort(x, 1)[0][:, b:k - b].mean(1), reps=3,
                                   warmup=1),
                bound_ms=bnd, bound_by=by)


def vmap_cell(torch, trimmed, fl, log_root: Path, name: str, model: str, s: int,
              local_steps: int = 1, dtype=None, chunks: int = 1, aggregator="trimmedmean",
              byzantine: int = MAIN_BYZANTINE, fault_model=None) -> dict:
    """One round of S experiments (client rates 0.1 * (1 + i / S), seeds i,
    one shared batch of ``local_steps`` x 32) in map mode and in vmap mode
    on one engine: each mode cold (its graph captured, or eager), then
    VMAP_WARM warm rounds timed, with the launches of each warm round
    counted, the peak memory above what was resident of the cold round
    (the eager round and the capture) and of a warm one, and a profiled warm
    round; the two modes' params compared. Returns the record."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.core import ExperimentBatch
    from blades_tpu_torch.utils import rng

    gc.collect()
    torch.cuda.empty_cache()
    kws = {"num_byzantine": byzantine} if aggregator == "trimmedmean" else {}
    sim = Simulator(dataset=fl, attack="alie", num_byzantine=byzantine, aggregator=aggregator,
                    aggregator_kws=kws, seed=1, log_path=str(log_root / name))
    sim.run(model=model, global_rounds=0, client_chunks=chunks, compute_dtype=dtype,
            fault_model=fault_model)
    eng = sim.engine
    p0 = {n: t.clone() for n, t in sim.server.state.params.items()}
    cx, cy = fl.sample_round(rng.generator(1, 501, rng.DATA, device=eng.device), local_steps, 32)
    c_lrs = [0.1 * (1 + i / s) for i in range(s)]
    s_lrs, seeds = [1.0] * s, list(range(s))
    rec, params = {"phase": "experiments_vmap", "cell": name, "model": model, "experiments": s,
                   "clients": eng.num_clients, "dim": eng.dim, "local_steps": local_steps,
                   "dtype": str(dtype or "float32"), "client_chunks": eng.client_chunks,
                   "aggregator": aggregator, "fault_model": fault_model is not None}, {}
    recorder = None
    for mode in ("map", "vmap"):
        eb = ExperimentBatch(eng, s, mode=mode)
        init = eb.init_batch(p0)

        def one():
            return eb.run_round_batch(init, cx, cy, c_lrs, s_lrs, seeds, shared_data=True)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if mode == "vmap":
            with _BatchedRecorder(torch, trimmed) as recorder:
                states, _, _ = one()
        else:
            states, _, _ = one()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        # the cold round's peak: its eager round (a graph's warm-up) and the
        # capture into the graph's pool, which a replay then reuses
        cold_peak = torch.cuda.max_memory_allocated() - base
        params[mode] = states.params
        warm, counts = [], []
        for _ in range(VMAP_WARM):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = (trimmed.trimmed_mean_launches, trimmed.trimmed_mean_batched_launches)
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            counts.append((trimmed.trimmed_mean_launches - before[0],
                           trimmed.trimmed_mean_batched_launches - before[1]))
        peak = torch.cuda.max_memory_allocated() - base
        prof = profiled_block(torch, trimmed, one)
        rec[mode] = dict(cold_round_s=cold, warm_round_s=warm,
                         warm_per_experiment_round_s=[w / s for w in warm],
                         cold_peak_mem_above_resident_bytes=cold_peak,
                         warm_peak_mem_above_resident_bytes=peak, launches_per_round=counts,
                         block_mode=eng.last_block_mode, block_reason=eng.last_block_reason,
                         profiled_wall_ms=prof["wall_ms"],
                         device_busy_ms=prof["dev"]["busy_ms"],
                         device_busy_share=prof["dev"]["busy_ms"] / prof["wall_ms"],
                         profiled_kernel_events=prof["events"],
                         profiled_counted_launches=prof["counted"])
    eng.last_graph = None
    bf16 = dtype is not None
    errs = []
    for i in range(s):
        for n in p0:
            a, b = params["vmap"][n][i], params["map"][n][i]
            errs.append(_rel_l2(a, b) if bf16 else float(((a - b).abs() - 1e-5 * b.abs()).max()))
    rec["params_vs_map"] = ({"max_rel_l2": max(errs), "bar": BF16_ROW_REL} if bf16 else
                            {"max_abs_err_above_rtol": max(errs), "rtol": 1e-5, "atol": 1e-6})
    rec["speedup_per_experiment_round"] = min(rec["map"]["warm_round_s"]) / min(
        rec["vmap"]["warm_round_s"])
    kernel = aggregator == "trimmedmean" and fault_model is None
    if kernel:
        x, b, out = recorder.held[0]
        rec["batched_launch"] = dict(shape_skdb=[*x.shape, b],
                                     equal_to_recorded_output=bool(torch.equal(
                                         out, trimmed.trimmed_mean_batched_cuda(x, b))),
                                     **batched_launch_check(torch, trimmed, x, b))
        rec["_held"] = (x, b)
    sim = None
    check(all(c == (s, 0) for c in rec["map"]["launches_per_round"]) if kernel else True,
          f"{name}: map-mode launches {rec['map']['launches_per_round']}")
    want = (1, 1) if kernel else (0, 0)
    check(all(c == want for c in rec["vmap"]["launches_per_round"]),
          f"{name}: vmap-mode launches {rec['vmap']['launches_per_round']}, want {want} a round")
    if kernel:
        bl = rec["batched_launch"]
        check(bl["equal_to_single_launches"] and bl["within_tol"] and
              bl["equal_to_recorded_output"], f"{name}: batched launch {bl}")
    check(max(errs) <= (BF16_ROW_REL if bf16 else 1e-6),
          f"{name}: vmap and map params differ: {rec['params_vs_map']}")
    return rec


def phase_experiments_vmap(torch, trimmed, mlp_fl, cifar_fl, dev, card: str,
                           log_root: Path) -> tuple:
    """``ExperimentBatch(mode="vmap")`` against map mode: the MLP at K=1000
    (S=8), BASELINE config 1's shape (the MLP at K=10, 50 local steps,
    S=64), bf16 CCT-2 at K=1000 in 4 chunks (S=2), each under ALIE and
    trimmed mean, the kernel's batched entry once a vmap round against S
    single launches a map round; then a fault-model round and a GeoMed
    round (an eager, looping defense) at K=1000 (MLP, S=4). The batched
    launch of each kernel cell is held to S single launches and to the
    plain version; the one at [8, 1000, 59850] is timed; a batched input
    past 2^31 elements is held the same way. Returns the batched launches
    by cell, the timings and the max error."""
    from blades_tpu_torch.datasets import Synthetic

    config1 = Synthetic(num_clients=10, train_bs=32, train_size=60_000, test_size=10_000,
                        cache=False).get_dls(dev)
    cells = [("mlp_k1000_s8", mlp_fl, "mlp", VMAP_MLP_S, {}),
             ("config1_k10_s64", config1, "mlp", VMAP_CONFIG1_S,
              dict(local_steps=VMAP_CONFIG1_STEPS, byzantine=4)),
             ("cct2_bf16_k1000_s2", cifar_fl, "cct_2_3x2_32", VMAP_CCT2_S,
              dict(dtype="bfloat16", chunks=CCT2_CHUNKS)),
             ("mlp_k1000_fault_s4", mlp_fl, "mlp", VMAP_LOOP_S,
              dict(fault_model=FAULTS)),
             ("mlp_k1000_geomed_s4", mlp_fl, "mlp", VMAP_LOOP_S, dict(aggregator="geomed"))]
    trimmed.trimmed_mean_batched_launches = 0
    launches, timings, max_err = {}, None, 0.0
    for name, fl, model, s, kw in cells:
        before = trimmed.trimmed_mean_batched_launches
        rec = vmap_cell(torch, trimmed, fl, log_root, name, model, s, **kw)
        held = rec.pop("_held", None)
        if held is not None:
            max_err = max(max_err, rec["batched_launch"]["max_abs_err"])
            if name == "mlp_k1000_s8":
                timings = batched_kernel_timings(torch, trimmed, *held)
                rec["batched_kernel"] = timings
        launches[name] = sum(c[1] for c in rec["vmap"]["launches_per_round"])
        rec.update(card=card)
        emit(rec)
        del held
        check(trimmed.trimmed_mean_batched_launches >= before, name)
    del config1
    # S*K*D past 2^31
    gc.collect()
    torch.cuda.empty_cache()
    *shape, b = VMAP_BIG_SHAPE
    big = torch.empty(*shape, device=dev)
    for i in range(shape[0]):
        big[i].normal_(generator=torch.Generator(device=dev).manual_seed(i))
    got = trimmed.trimmed_mean_batched_cuda(big, b)
    equal = all(bool(torch.equal(got[i], trimmed.trimmed_mean_cuda(big[i], b)))
                for i in range(shape[0]))
    cols = slice(max(0, shape[2] - 65_536), shape[2])
    err = float((got[:, cols] - trimmed.trimmed_mean_batched_plain(
        big[:, :, cols].contiguous(), b)).abs().max())
    emit({"phase": "experiments_vmap_2e31", "shape_skdb": [*big.shape, b],
          "elements": big.numel(), "equal_to_single_launches": equal,
          "max_abs_err_last_columns": err, "card": card})
    check(big.numel() > 2**31 and equal and err <= TOL["atol"],
          f"experiments_vmap_2e31: equal {equal}, err {err}")
    del big, got
    return launches, timings, max(max_err, err)


def remat_cell(torch, fl, log_root: Path, name: str, model: str, dtype, chunks: int,
               byzantine: int, rows=None) -> dict:
    """``remat=False`` then ``remat=True`` on one store (ALIE, trimmed mean):
    for each, the engine built through Simulator.run, then a cold and
    REMAT_WARM warm rounds from one state on one batch (not applied), their
    walls and peak memory above what was resident; the updates of the two
    (``rows`` of them, or all) compared."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.utils import rng

    rec, ups = {"phase": "remat", "cell": name, "model": model,
                "dtype": str(dtype or "float32"), "client_chunks": chunks}, {}
    for flag in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        sim = Simulator(dataset=fl, attack="alie", num_byzantine=byzantine,
                        aggregator="trimmedmean", aggregator_kws={"num_byzantine": byzantine},
                        seed=1, log_path=str(log_root / f"{name}_{flag}"))
        sim.run(model=model, global_rounds=0, client_chunks=chunks, compute_dtype=dtype,
                remat=flag, retain_updates=True)
        eng, state = sim.engine, sim.server.state
        check(eng.remat is flag, f"{name}: engine remat {eng.remat}")
        cx, cy = fl.sample_round(rng.generator(1, 601, rng.DATA, device=eng.device), 1, 32)
        walls, peaks = [], []
        for _ in range(1 + REMAT_WARM):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            eng.run_round(state, cx, cy, 0.1, 1.0, seed=1)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated() - base)
        ups[flag] = eng.last_updates[rows].clone() if rows else eng.last_updates.clone()
        rec["remat" if flag else "no_remat"] = dict(
            cold_round_s=walls[0], warm_round_s=walls[1:], peak_mem_above_resident_bytes=peaks,
            clients=eng.num_clients, dim=eng.dim)
        eng.last_updates = None
        del sim, eng, state, cx, cy
    diff = (ups[True] - ups[False]).abs()
    rec.update(update_rows_compared=rows.stop if rows else ups[True].shape[0],
               max_abs_diff_updates=float(diff.max()),
               max_abs_update=float(ups[False].abs().max()),
               bit_identical=bool(torch.equal(ups[True], ups[False])),
               warm_ratio=min(rec["remat"]["warm_round_s"]) / min(
                   rec["no_remat"]["warm_round_s"]),
               peak_ratio=max(rec["remat"]["peak_mem_above_resident_bytes"]) / max(
                   rec["no_remat"]["peak_mem_above_resident_bytes"]))
    tol = ROUND_TOL if dtype is None else dict(rtol=BF16_ROW_REL, atol=1e-3)
    check(bool(torch.allclose(ups[True], ups[False], **tol)),
          f"{name}: remat changes the updates by {rec['max_abs_diff_updates']}")
    return rec


def phase_remat(torch, fl, card: str, log_root: Path) -> None:
    """``run(remat=True)`` against ``remat=False``: CCT-2 at K=1000 in 4
    chunks (bench.py's defaults), f32 and bf16."""
    k, _, b = CCT2_SHAPE
    for dtype in (None, "bfloat16"):
        rec = remat_cell(torch, fl, log_root, f"cct2_{dtype or 'float32'}_k{k}", "cct_2_3x2_32",
                         dtype, CCT2_CHUNKS, b)
        emit({**rec, "card": card})


def phase_remat_text(torch, fl, card: str, log_root: Path) -> None:
    """``text_cct_2`` at K=100, f32, one chunk (61 GB without remat), with
    and without remat; the updates of the first 10 clients compared."""
    k, _, b = TEXT_SHAPE
    rec = remat_cell(torch, fl, log_root, f"text_cct2_float32_k{k}", "text_cct_2", None,
                     TEXT_CHUNKS["float32"], b, rows=slice(0, 10))
    emit({**rec, "card": card})



def vmap_remat_phases(torch, trimmed, dev, card: str, log_root: Path) -> tuple:
    """The MLP K=1000 and CIFAR-shaped K=1000 stores of the main path,
    built anew, and ``phase_experiments_vmap`` and ``phase_remat`` on them
    (cuDNN deterministic). Returns what ``phase_experiments_vmap`` does."""
    from blades_tpu_torch.datasets import Synthetic

    gc.collect()
    torch.cuda.empty_cache()
    with deterministic_cudnn():
        mlp = Synthetic(num_clients=MAIN_CLIENTS, train_bs=32, train_size=50_000,
                        cache=False).get_dls(dev)
        cifar = Synthetic(num_clients=CCT2_SHAPE[0], sample_shape=(32, 32, 3), train_bs=32,
                          train_size=50_000, test_size=10_000, cache=False).get_dls(dev)
        out = phase_experiments_vmap(torch, trimmed, mlp, cifar, dev, card, log_root)
        phase_remat(torch, cifar, card, log_root)
    return out


def vmap_phases(torch, trimmed, dev, card: str, log_root: Path) -> tuple:
    """``--vmap-only``: the text remat cell on its store, then
    :func:`vmap_remat_phases`."""
    with deterministic_cudnn():
        phase_remat_text(torch, text_stores(torch, dev)["k100"], card, log_root)
    return vmap_remat_phases(torch, trimmed, dev, card, log_root)


# -- resilient sweeps and the run supervisor (slice 13a) ----------------------------


class _HeldKernel:
    """The kernel's wrapper, each launch held at once against the plain
    version on its own input (``TOL``): the errors stay on the card until
    :meth:`result` reads them. Installed over ``trimmed.trimmed_mean_cuda``
    (the defense's route), the launches still counted by the wrapper."""

    def __init__(self, torch, trimmed, keep_first: bool = False):
        self.torch, self.trimmed = torch, trimmed
        self.orig = trimmed.trimmed_mean_cuda
        self.errs, self.bad = [], []
        self.keep_first, self.first = keep_first, None  # the first launch's input and b

    def __call__(self, x, b):
        out = self.orig(x, b)
        if self.keep_first and self.first is None:
            self.first = (x.clone(), b)
        self._hold(out, self.trimmed.trimmed_mean_plain(x, b))
        return out

    def _hold(self, out, ref):
        self.errs.append((out - ref).abs().max())
        self.bad.append((~self.torch.isclose(out, ref, **TOL)).sum())

    def __enter__(self):
        self.trimmed.trimmed_mean_cuda = self
        return self

    def __exit__(self, *exc):
        self.trimmed.trimmed_mean_cuda = self.orig
        return False

    def result(self) -> tuple:
        """(launches held, largest error, elements off TOL)."""
        if not self.errs:
            return 0, 0.0, 0
        return (len(self.errs), float(self.torch.stack(self.errs).max()),
                int(self.torch.stack(self.bad).sum()))


def phase_resilient_certify(torch, trimmed, dev, card: str, log_root: Path, ref: dict) -> tuple:
    """The certify phase's configuration (CERT_ARGS) cut to RESIL_AGGS,
    through its ``main`` with ``--attempts 2``, a
    ``ResilienceOptions.runner`` that raises for RESIL_POISON and
    otherwise calls ``sweeps._execute_group``: that cell's
    group is retried, bisected, and the cell alone quarantined (one
    ``quarantine`` record, one journal line); every other cell's result,
    verdict and ratio equal to the ``certify`` phase's run (``ref``) bit for
    bit; the kernel's launches equal to the plan's without the poison cell,
    each held against the plain version. Returns the launches and the
    largest error."""
    import contextlib
    import functools
    import io

    from blades_tpu_torch.audit import DEFAULT_GRIDS
    from blades_tpu_torch.examples import certify
    from blades_tpu_torch.sweeps import _execute_group

    out_dir = log_root / "resilient_certify"
    kept, calls = {}, []
    orig_exec, orig_opts = certify.execute_cells, certify.ResilienceOptions

    def runner(group, key):
        calls.append(len(group))
        if any(c.label == RESIL_POISON for c in group):
            raise RuntimeError(f"injected failure of {RESIL_POISON}")
        return _execute_group(group, key, grids=DEFAULT_GRIDS)

    def execute_cells(*a, **kw):
        out = orig_exec(*a, **kw)
        kept.update(specs=a[2], results=out[0], report=out[2])
        return out

    certify.execute_cells = execute_cells
    certify.ResilienceOptions = functools.partial(orig_opts, runner=runner)
    buf = io.StringIO()
    torch.cuda.synchronize()
    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    try:
        with _HeldKernel(torch, trimmed) as held, contextlib.redirect_stdout(buf):
            rc = certify.main([*CERT_ARGS, "--device", str(dev), "--attempts", "2",
                               "--aggs", *RESIL_AGGS,
                               "--out", str(out_dir)])
        torch.cuda.synchronize()
    finally:
        certify.execute_cells, certify.ResilienceOptions = orig_exec, orig_opts
    wall = time.perf_counter() - t0
    launches = trimmed.trimmed_mean_launches
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    matrix = json.loads((out_dir / "cert_matrix.json").read_text())
    report = kept["report"]
    labels = [s.label for s in kept["specs"]]
    ref_by = dict(zip((s.label for s in ref["specs"]), ref["results"]))
    differ = [lab for lab, r in zip(labels, kept["results"])
              if lab != RESIL_POISON and r != ref_by[lab]]
    rows = {(r["agg"], r["f"], r.get("scenario")): (r["certified"], r["worst_ratio"])
            for r in matrix["cells"] + matrix["async_cells"]}
    ref_rows = {(r["agg"], r["f"], r.get("scenario")): (r["certified"], r["worst_ratio"])
                for r in ref["matrix"]["cells"] + ref["matrix"]["async_cells"]
                if r["agg"] in RESIL_AGGS}
    rows_differ = [list(k) for k, v in ref_rows.items() if rows.get(k) != v]
    args = certify.parse_args(list(CERT_ARGS))
    search, battery = certify_expected_launches(
        [s for s in kept["specs"] if s.label != RESIL_POISON], args.clients, args.trials,
        DEFAULT_GRIDS)
    records = [json.loads(line) for line in (out_dir / "sweep_trace.jsonl").read_text()
               .splitlines() if line.strip()]
    journal = [json.loads(line) for line in (out_dir / "sweep_journal.jsonl").read_text()
               .splitlines() if line.strip()]
    held_n, err, off = held.result()
    emit({"phase": "resilient_certify", "rc": rc, "ok": summary["ok"], "cells": len(labels),
          "quarantined": summary["quarantined"], "retried": report.retried,
          "degraded_groups": report.degraded_groups, "executed": report.executed,
          "group_sizes_run": calls, "wall_s": wall, "ref_wall_s": ref["wall"],
          "results_differ": differ[:20], "rows_differ": rows_differ[:20],
          "launches": launches, "launches_planned_search": search,
          "launches_planned_battery": battery, "launches_held": held_n, "max_abs_err": err,
          "elements_off_tol": off, "card": card})
    check(rc == 1 and summary["quarantined"] == [RESIL_POISON] and not summary["ok"],
          f"resilient_certify: rc {rc}, {summary}")
    check([q["cell"] for q in report.quarantined] == [RESIL_POISON]
          and [r["cell"] for r in records if r["t"] == "quarantine"] == [RESIL_POISON]
          and [r["cell"] for r in journal if r.get("kind") == "quarantine"] == [RESIL_POISON],
          "resilient_certify: the quarantine records")
    check(report.retried >= 1 and report.degraded_groups >= 1, f"resilient_certify: {report}")
    poison_agg, _, poison_f = RESIL_POISON.partition("/f")
    check(not differ and rows_differ == [[poison_agg, int(poison_f), None]],
          f"resilient_certify: results {differ[:10]}, rows {rows_differ}")
    check(launches == search + battery == held_n and off == 0,
          f"resilient_certify: {launches} launches ({held_n} held, {off} elements off TOL), "
          f"the plan makes {search} + {battery}")
    return launches, err


def phase_resilient_oom(torch, trimmed, dev, card: str) -> tuple:
    """A real ``torch.cuda.OutOfMemoryError`` salvaged by bisection: a group
    of OOM_CELLS trimmed-mean search cells at K=100 and CCT-2's D, its
    trials on the host and staged onto the card by the group's runner (so
    a group's memory grows with its cells), run uncapped (the whole group,
    then a half) for the peaks of reserved memory; then the allocator is
    capped between the two (``set_per_process_memory_fraction``) and the
    group run under ``run_grouped_resilient``: it fails its 2 attempts,
    bisects, and every cell's result equals the uncapped run's bit for bit.
    Each launch is held against the plain version. Returns the capped
    run's launches and the largest error."""
    import dataclasses

    from blades_tpu_torch.audit import QUICK_GRIDS, battery_ctx, synthetic_honest
    from blades_tpu_torch.examples.certify import build_aggregator
    from blades_tpu_torch.sweeps import SweepCell, _execute_group, group_key
    from blades_tpu_torch.sweeps.resilient import ResilienceOptions, run_grouped_resilient

    k, d = CERT_SCALE_CLIENTS, CCT2_SHAPE[1]
    agg = build_aggregator("trimmedmean", k, OOM_B)
    g = torch.Generator(device="cpu").manual_seed(0)
    ctx = battery_ctx(None, k, d, device=dev)
    cells = [SweepCell(f"oom/f{f}", agg=agg, f=f, ctx=ctx,
                       trials=synthetic_honest(g, OOM_TRIALS, k, d, device="cpu"))
             for f in range(3, 3 + OOM_CELLS)]
    key = group_key(cells[0])
    attempts = []

    def runner(group, key_):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = trimmed.trimmed_mean_launches
        rec = {"cells": len(group), "first": group[0].label}
        attempts.append(rec)
        try:
            staged = [dataclasses.replace(c, trials=c.trials.to(dev)) for c in group]
            return _execute_group(staged, key_, grids=QUICK_GRIDS)
        except torch.cuda.OutOfMemoryError:
            rec["oom"] = True
            raise
        finally:
            rec.update(peak_reserved=torch.cuda.max_memory_reserved(),
                       peak_allocated=torch.cuda.max_memory_allocated(),
                       launches=trimmed.trimmed_mean_launches - n0)

    def fresh():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    total = torch.cuda.get_device_properties(0).total_memory
    with _HeldKernel(torch, trimmed) as held:
        fresh()
        whole = runner(cells, key)
        fresh()
        runner(cells[: OOM_CELLS // 2], key)
        peak_whole, peak_half = attempts[0]["peak_reserved"], attempts[1]["peak_reserved"]
        cap = (peak_half + peak_whole) // 2
        fresh()
        trimmed.trimmed_mean_launches = 0
        attempts.clear()
        torch.cuda.set_per_process_memory_fraction(cap / total, 0)
        t0 = time.perf_counter()
        try:
            results, _, report = run_grouped_resilient(
                cells, options=ResilienceOptions(attempts=2, runner=runner, base_delay_s=0.0))
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, 0)
        wall = time.perf_counter() - t0
    launches = trimmed.trimmed_mean_launches
    held_n, err, off = held.result()
    sizes = [a["cells"] for a in attempts]
    levels = int(math.log2(OOM_CELLS / min(sizes))) if sizes else 0
    emit({"phase": "resilient_oom", "cells": OOM_CELLS, "k": k, "d": d, "b": OOM_B,
          "trials": OOM_TRIALS, "peak_reserved_whole": peak_whole,
          "peak_reserved_half": peak_half, "cap_bytes": cap, "card_bytes": total,
          "attempts": attempts, "bisection_levels": levels, "retried": report.retried,
          "degraded_groups": report.degraded_groups, "quarantined": report.summary()[
              "quarantined"], "wall_s": wall, "launches": launches,
          "launches_held_all_runs": held_n, "max_abs_err": err, "elements_off_tol": off,
          "card": card})
    check(peak_half < cap < peak_whole, f"resilient_oom: no cap between {peak_half} and "
          f"{peak_whole}")
    check(attempts[0].get("oom") and attempts[1].get("oom") and sizes[:2] == [OOM_CELLS] * 2,
          f"resilient_oom: the capped group did not run out of memory twice: {attempts}")
    check(report.retried >= 1 and report.degraded_groups >= 1 and not report.quarantined,
          f"resilient_oom: {report}")
    check(results == whole, "resilient_oom: a salvaged cell differs from the uncapped run")
    check(launches > 0 and off == 0, f"resilient_oom: {launches} launches, {off} elements "
          f"off TOL")
    return launches, err


def sticky_child(out_dir: str) -> int:
    """``--sticky-child OUT``: the certify driver (``STICKY_ARGS``) on the
    card, resilient, whose runner kills the CUDA context at STICKY_CELL's
    group once (a sentinel beside OUT disarms it for the relaunch): the
    kernel's raw entry on an address nothing owns. The executor must raise
    ``DeviceLost`` and journal no quarantine. Each kernel launch is held
    against the plain version; a ``STICKY`` line gives the launches."""
    import functools
    import os

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from blades_tpu_torch.audit import QUICK_GRIDS
    from blades_tpu_torch.examples import certify
    from blades_tpu_torch.ops import trimmed
    from blades_tpu_torch.sweeps import _execute_group
    from blades_tpu_torch.utils.platform import set_numerics

    set_numerics(matmul_allow_tf32=False)
    sentinel = Path(out_dir + ".fault_fired")

    def runner(group, key):
        if any(c.label == STICKY_CELL for c in group) and not sentinel.exists():
            sentinel.touch()
            out = torch.empty(1 << 20, device="cuda")
            trimmed._library().blades_trimmed_mean_f32(
                16, out.data_ptr(), 8, 1 << 20, 1, torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()  # the illegal address surfaces here
        return _execute_group(group, key, grids=QUICK_GRIDS)

    certify.ResilienceOptions = functools.partial(certify.ResilienceOptions, runner=runner)
    trimmed.trimmed_mean_launches = 0
    with _HeldKernel(torch, trimmed) as held:
        rc = certify.main([*STICKY_ARGS, "--attempts", "2", "--out", out_dir])
        launches = trimmed.trimmed_mean_launches
        try:
            checked = held.result()
        except RuntimeError as e:  # the dead context: nothing more to read
            checked = (None, None, f"{type(e).__name__}: {e}"[:200])
    print("STICKY " + json.dumps({"rc": rc, "launches": launches, "held": checked[0],
                                  "max_abs_err": checked[1], "elements_off_tol": checked[2],
                                  "attempt": os.environ.get("BLADES_ATTEMPT")}), flush=True)
    # a dead context may hang the interpreter's teardown
    os._exit(rc)


def run_sticky(log_root: Path) -> dict:
    """The sticky child (``--sticky-child``) under the run supervisor. It
    runs beside the main thread's phases, so it only gathers: no record,
    no check."""
    import os

    from blades_tpu_torch.supervision import Supervisor

    out = log_root / "sticky"
    log = log_root / "sticky.log"
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        result = Supervisor(
            [sys.executable, str(Path(__file__).resolve()), "--sticky-child", str(out)],
            attempts=2, base_delay_s=0.5, poll_s=0.2, startup_grace_s=600,
            telemetry_path=str(log_root / "sticky_supervisor.jsonl"),
            heartbeat_file=str(log_root / "sticky_hb"), env={
                "BLADES_LEDGER": os.environ["BLADES_LEDGER"], **BESIDE_ENV},
            cwd=str(Path(__file__).resolve().parent), stdout=fh,
            stderr=subprocess.STDOUT).run()
    return dict(result=result, wall=time.perf_counter() - t0, text=log.read_text(),
                journal=_notes(out / "sweep_journal.jsonl"))


def report_sticky(run: dict, card: str) -> tuple:
    """``resilient_sticky``: the first attempt's device fault made the
    executor raise (no quarantine journaled, the process exited 1), and the
    relaunch under ``BLADES_RESUME=1`` recovered the journaled cells and
    finished with no quarantine. Returns the kernel launches of both
    attempts and the largest error."""
    result, text, journal = run["result"], run["text"], run["journal"]
    lines = [json.loads(line[7:]) for line in text.splitlines() if line.startswith("STICKY ")]
    summaries = [json.loads(line) for line in text.splitlines()
                 if line.startswith('{"metric": "defense_certification"')]
    errs = [x["max_abs_err"] for x in lines if isinstance(x.get("max_abs_err"), float)]
    emit({"phase": "resilient_sticky", "ok": result.ok,
          "attempts": [dict(reason=a.reason, returncode=a.returncode, resumed=a.resumed,
                            wall_s=a.wall_s) for a in result.attempts],
          "children": lines, "first_error": summaries[0].get("error") if summaries else None,
          "final": summaries[-1] if summaries else None,
          "journal_quarantines": sum(r.get("kind") == "quarantine" for r in journal),
          "journal_cells": sum(r.get("kind") == "cell" for r in journal),
          "wall_s": run["wall"], "card": card})
    check(result.ok and len(result.attempts) == 2 and result.attempts[0].returncode == 1
          and result.attempts[1].resumed, f"resilient_sticky: {result}\n{text[-3000:]}")
    check(len(summaries) == 2 and "DeviceLost" in summaries[0].get("error", "")
          and summaries[1]["ok"] and summaries[1]["quarantined"] == []
          and summaries[1]["resumed_skipped"] > 0, f"resilient_sticky: {summaries}")
    check(not any(r.get("kind") == "quarantine" for r in journal),
          "resilient_sticky: a quarantine was journaled")
    check(len(lines) == 2 and lines[1]["elements_off_tol"] == 0 and lines[1]["launches"] > 0,
          f"resilient_sticky: {lines}")
    return sum(x["launches"] for x in lines), max(errs, default=0.0)


def _notes(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def recovery_split(events: list, notes: list, records: list) -> dict:
    """The time to recover of a supervised run hung once, from the hang to
    the relaunch's first finished round: detection (the hang to the
    watchdog's decision), the group kill (SIGTERM, the crash autosave,
    the exit), the backoff to the relaunch, the process's start (the launch
    to CUDA ready: the interpreter, the imports, CUDA's start), the
    kernel's load, the data, the restore (the ``restore`` span) and the
    first round (the run's start to the round's end, the engine's build
    included, the restore not)."""
    kill = next(e for e in events if e["event"] == "kill")
    relaunch = [e for e in events if e["event"] == "launch"][1]
    hang = next(n for n in notes if n["event"] == "hang")
    second = [n for n in notes if n["attempt"] == 2]
    at = {n["event"]: n["ts"] for n in second if n["event"] != "round"}
    first_round = next(n for n in second if n["event"] == "round")
    restore = sum(r["dur_s"] for r in records if r.get("t") == "span"
                  and r.get("path") == "restore" and r.get("attempt") == 2)
    decided = kill["ts"] - kill["kill_s"]
    split = {
        "detection_s": decided - hang["ts"],
        "kill_s": kill["kill_s"],
        "backoff_s": relaunch["ts"] - kill["ts"],
        "process_start_s": at["cuda"] - relaunch["ts"],
        "kernel_load_s": at["kernel"] - at["cuda"],
        "data_s": at["data"] - at["kernel"],
        "restore_s": restore,
        "first_round_s": first_round["ts"] - at["run"] - restore,
    }
    split["total_s"] = first_round["ts"] - hang["ts"]
    split["unaccounted_s"] = split["total_s"] - sum(v for k, v in split.items()
                                                    if k != "total_s")
    split["first_round"] = first_round["round"]
    return split


def _sup_args():
    import argparse

    return argparse.Namespace(workload="cct2", device="cuda", rounds=SUP_ROUNDS)


def run_sup_reference(log_root: Path) -> dict:
    """The uninterrupted CCT-2 child of ``supervised_cct2`` (killed at exit
    should a phase fail before it ends). It runs beside the main thread's
    phases: its wall is reported, not its parts."""
    import atexit
    import os

    from blades_tpu_torch.examples import supervised_run

    root = Path(__file__).resolve().parent
    env = {"PYTHONPATH": str(root), "BLADES_LEDGER": os.environ["BLADES_LEDGER"], **BESIDE_ENV}
    params, notes = log_root / "sup_ref.pt", log_root / "sup_ref_notes.jsonl"
    t0 = time.perf_counter()
    with open(log_root / "sup_ref.log", "w") as fh:
        proc = subprocess.Popen(supervised_run.child_cmd(_sup_args(), str(log_root / "sup_ref"),
                                                         str(params), 0, str(notes)),
                                stdout=fh, stderr=subprocess.STDOUT, cwd=str(root),
                                env=dict(os.environ, **env))
        atexit.register(proc.kill)
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    return dict(rc=rc, wall=time.perf_counter() - t0, params=params, notes=notes,
                log=log_root / "sup_ref.log")


def start_sup_reference(log_root: Path) -> dict:
    """:func:`run_sup_reference` in a thread of its own, from here; its
    result is ``handle["ref"]`` once ``handle["thread"]`` has ended."""
    import threading

    handle = {}
    handle["thread"] = threading.Thread(
        target=lambda: handle.update(ref=run_sup_reference(log_root)), daemon=True)
    handle["thread"].start()
    return handle


def run_supervised(torch, log_root: Path, ref_handle=None) -> dict:
    """The uninterrupted CCT-2 child (``run_sup_reference``; or the one of
    ``ref_handle``, started before by :func:`start_sup_reference`), then
    the same under the run supervisor, hung once at SUP_HANG_AT; the card's
    free memory sampled at each poll of the supervisor. It runs beside the
    main thread's phases, so it only gathers."""
    import os

    from blades_tpu_torch.examples import supervised_run
    from blades_tpu_torch.supervision import Supervisor

    if ref_handle is None:
        ref = run_sup_reference(log_root)
    else:
        ref_handle["thread"].join(timeout=900)
        check("ref" in ref_handle, "supervised_cct2: the uninterrupted child did not end")
        ref = ref_handle["ref"]
    root = Path(__file__).resolve().parent
    env = {"PYTHONPATH": str(root), "BLADES_LEDGER": os.environ["BLADES_LEDGER"]}
    samples = []

    def sleep(s):
        samples.append((time.time(), torch.cuda.mem_get_info()[0]))
        time.sleep(s)

    out = log_root / "sup"
    params, notes = log_root / "sup.pt", log_root / "sup_notes.jsonl"
    t0 = time.perf_counter()
    with open(log_root / "sup.log", "w") as fh:
        result = Supervisor(
            supervised_run.child_cmd(_sup_args(), str(out), str(params), SUP_HANG_AT,
                                     str(notes)),
            heartbeat_timeout_s=SUP_HEARTBEAT_S, startup_grace_s=600.0, attempts=2,
            base_delay_s=1.0, term_grace_s=SUP_TERM_GRACE_S, poll_s=0.2,
            telemetry_path=str(out / "telemetry.jsonl"),
            heartbeat_file=str(log_root / "sup_hb"), env=env, cwd=str(root), stdout=fh,
            stderr=subprocess.STDOUT, sleep=sleep).run()
    return dict(ref=ref, result=result, wall=time.perf_counter() - t0, samples=samples,
                params=params, notes=notes, telemetry=out / "telemetry.jsonl",
                log=log_root / "sup.log")


def report_supervised(torch, run: dict, card: str) -> tuple:
    """``supervised_cct2``: CCT-2 at K=1000 in 4 chunks, bf16, ALIE f=5 +
    trimmed mean b=5, a checkpoint a round, SUP_ROUNDS rounds
    (``examples/supervised_run.py --child --workload cct2``), hung at
    SUP_HANG_AT under the run supervisor: a heartbeat kill with no process
    left, a crash autosave naming ``SupervisorTermination``, a relaunch
    under ``BLADES_RESUME=1`` whose final params are ``torch.equal`` to the
    uninterrupted child's, the trace's ``launch``, ``kill``, ``retry``,
    ``launch``, ``complete``. The time to recover split
    (``recovery_split``), the card's free memory before and after the
    kill, the relaunch's kernel library reused. The children count the
    kernel's launches and hold each round's launch against the plain
    version on the round's own update matrix. Returns the launches (both
    children) and the largest error."""
    ref, result, samples = run["ref"], run["result"], run["samples"]
    check(ref["rc"] == 0, "supervised_cct2: the uninterrupted child failed:\n"
          + ref["log"].read_text()[-3000:])
    check(result.ok and len(result.attempts) == 2, "supervised_cct2: " + str(result) + "\n"
          + run["log"].read_text()[-3000:])
    first, second = result.attempts
    records = _notes(run["telemetry"])
    events = [r for r in records if r.get("t") == "supervisor"]
    notes, ref_n = _notes(run["notes"]), _notes(ref["notes"])
    split = recovery_split(events, notes, records)
    kill = next(e for e in events if e["event"] == "kill")
    decided = kill["ts"] - kill["kill_s"]
    before = [f for ts, f in samples if ts <= decided]
    after = [f for ts, f in samples if ts >= kill["ts"]]
    exact = torch.equal(torch.load(ref["params"]), torch.load(run["params"]))
    crash = [r for r in records if r.get("t") == "crash_checkpoint"]
    rounds = sorted({r["round"] for r in records if r.get("t") == "round"})
    child_rounds = [n for n in ref_n + notes if n["event"] == "round"]
    errs = [n["max_abs_err"] for n in child_rounds if n.get("max_abs_err") is not None]
    launches = {"uninterrupted": next(n["launches"] for n in ref_n if n["event"] == "done"),
                "attempt_1": max(n["launches"] for n in notes
                                 if n["event"] == "round" and n["attempt"] == 1),
                "attempt_2": next(n["launches"] for n in notes if n["event"] == "done")}
    kernel_notes = [n for n in notes if n["event"] == "kernel"]
    emit({"phase": "supervised_cct2", "clients": CCT2_SHAPE[0], "rounds": SUP_ROUNDS,
          "hang_at": SUP_HANG_AT, "heartbeat_timeout_s": SUP_HEARTBEAT_S,
          "attempts": [dict(reason=a.reason, returncode=a.returncode, resumed=a.resumed,
                            survivors=list(a.survivors), wall_s=a.wall_s)
                       for a in result.attempts],
          "events": [e["event"] for e in events], "kill": kill,
          "crash_checkpoint": crash, "rounds_recorded": rounds, "params_equal": exact,
          "recovery": split, "uninterrupted_wall_s": ref["wall"],
          "supervised_wall_s": run["wall"],
          "free_bytes_before_kill": before[-1] if before else None,
          "free_bytes_after_kill": after[0] if after else None,
          "given_back_bytes": (after[0] - before[-1]) if before and after else None,
          "kernel_library": [n["counters"] for n in kernel_notes],
          "launches": launches, "rounds_held": len(errs),
          "max_abs_err": max(errs, default=None), "card": card})
    kinds = [e["event"] for e in events]
    check(first.reason == "heartbeat_stale" and first.survivors == () and second.resumed
          and second.reason == "exit", f"supervised_cct2: {result.attempts}")
    check(all(x in kinds for x in ("launch", "kill", "retry", "complete"))
          and kinds.count("launch") == 2, f"supervised_cct2: {kinds}")
    check(len(crash) == 1 and crash[0]["round"] == SUP_HANG_AT
          and "SupervisorTermination" in crash[0]["error"], f"supervised_cct2: {crash}")
    check(exact, "supervised_cct2: the resumed params differ from the uninterrupted run's")
    check(rounds == [r for r in range(1, SUP_ROUNDS + 1) if r != SUP_HANG_AT],
          f"supervised_cct2: rounds {rounds}")
    check(len(kernel_notes) == 2 and all(n["counters"].get("cuda.kernel_reuses") == 1
                                         and not n["counters"].get("cuda.kernel_builds")
                                         for n in kernel_notes),
          f"supervised_cct2: the relaunch built the kernel again: {kernel_notes}")
    check(launches == {"uninterrupted": SUP_ROUNDS, "attempt_1": SUP_HANG_AT,
                       "attempt_2": SUP_ROUNDS - SUP_HANG_AT}, f"supervised_cct2: {launches}")
    check(len(errs) == 2 * SUP_ROUNDS and all(n["kernel_ok"] for n in child_rounds),
          f"supervised_cct2: the kernel against its plain version: {child_rounds}")
    check(before and after and after[0] > before[-1], "supervised_cct2: no memory came back")
    return sum(launches.values()), max(errs, default=0.0)


def run_chaos_children(log_root: Path) -> dict:
    """A chaos child SIGKILLed at CHAOS_KILL_AT under the supervisor, and
    the uninterrupted child beside it. Runs beside the main thread's
    phases: it only gathers."""
    import os

    import numpy as np

    from blades_tpu_torch.supervision import Supervisor

    root = Path(__file__).resolve().parent
    env = {"PYTHONPATH": str(root), "BLADES_LEDGER": os.environ["BLADES_LEDGER"], **BESIDE_ENV}
    child = [sys.executable, "-m", "blades_tpu_torch.examples.chaos", "--child", "--seed",
             str(CHAOS_KILL_SEED)]
    t0 = time.perf_counter()
    with open(log_root / "chaos_ref.log", "w") as ref_fh, \
            open(log_root / "chaos_child.log", "w") as fh:
        ref = subprocess.Popen(child + ["--out", str(log_root / "chaos_ref"), "--params-out",
                                        str(log_root / "chaos_ref.npy")],
                               stdout=ref_fh, stderr=subprocess.STDOUT, cwd=str(root),
                               env=dict(os.environ, **env))
        result = Supervisor(
            child + ["--out", str(log_root / "chaos_sup"), "--params-out",
                     str(log_root / "chaos_sup.npy"), "--kill-at", str(CHAOS_KILL_AT)],
            attempts=2, base_delay_s=0.5, poll_s=0.2, startup_grace_s=600,
            heartbeat_file=str(log_root / "chaos_hb"), env=env, cwd=str(root), stdout=fh,
            stderr=subprocess.STDOUT).run()
        ref.wait(timeout=600)
    exact = bool(ref.returncode == 0 and result.ok and np.array_equal(
        np.load(log_root / "chaos_ref.npy"), np.load(log_root / "chaos_sup.npy")))
    return dict(result=result, exact=exact, wall=time.perf_counter() - t0,
                log=(log_root / "chaos_child.log").read_text()[-3000:]
                + (log_root / "chaos_ref.log").read_text()[-2000:])


def phase_chaos(torch, card: str, log_root: Path, children: dict) -> int:
    """``examples/chaos.py --sweep CHAOS_SCENARIOS`` on the card (one seed
    for each defense of the pool, under fault weather: the masked forms,
    no kernel launch) with zero invariant violations; and the SIGKILLed
    child of ``run_chaos_children`` bit for bit the uninterrupted child.
    Returns the kernel's launches."""
    import contextlib
    import io

    from blades_tpu_torch.examples import chaos
    from blades_tpu_torch.ops import trimmed

    buf = io.StringIO()
    trimmed.trimmed_mean_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = chaos.main(["--sweep", str(CHAOS_SCENARIOS), "--out", str(log_root / "chaos")])
    wall = time.perf_counter() - t0
    launches = trimmed.trimmed_mean_launches
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    result = children["result"]
    emit({"phase": "chaos", "rc": rc, "ok": summary["ok"], "scenarios": summary["scenarios"],
          "aggregators_covered": summary["aggregators_covered"],
          "inertness_pairs": summary["inertness_pairs"], "block_pairs": summary["block_pairs"],
          "async_scenarios": summary["async_scenarios"], "violations": summary["violations"],
          "quarantined": summary["quarantined_cells"], "engine_cache": {
              k: summary["engine_cache"][k] for k in ("hits", "misses")},
          "device": summary["device"], "sweep_wall_s": wall, "launches": launches,
          "kill_child": {"attempts": [dict(reason=a.reason, returncode=a.returncode,
                                           resumed=a.resumed) for a in result.attempts],
                         "params_equal": children["exact"], "wall_s": children["wall"]},
          "card": card})
    check(rc == 0 and summary["ok"] and summary["violations"] == []
          and summary["scenarios"] == CHAOS_SCENARIOS and summary["device"] == "cuda",
          f"chaos: {summary['violations'][:10]} {summary['quarantined_cells']}")
    check(children["exact"] and result.attempts[0].returncode == -9
          and result.attempts[1].resumed,
          "chaos: the SIGKILLed child did not resume bit for bit:\n" + children["log"])
    return launches


def resilient_phases(torch, trimmed, dev, card: str, log_root: Path, cert_ref: dict,
                     sup_ref=None) -> dict:
    """The slice 13a phases, each path's launches counted alone. The child
    processes run in three threads (the sticky child; the chaos children;
    the CCT-2 children, uninterrupted and supervised, or only the
    supervised one when ``sup_ref`` holds a :func:`start_sup_reference`
    started before) beside the OOM group and the resilient certify run of
    this process, whose allocations move the card's free memory by
    megabytes while the supervised child's kill gives back gigabytes; then
    the chaos sweep. Each thread only gathers: the records and checks are
    made here after. Returns the launches by path and the largest error."""
    from concurrent.futures import ThreadPoolExecutor

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches, errs = {}, []
    with ThreadPoolExecutor(max_workers=3) as pool:
        sticky_run = pool.submit(run_sticky, log_root)
        chaos_run = pool.submit(run_chaos_children, log_root)
        supervised = pool.submit(run_supervised, torch, log_root, sup_ref)
        launches["resilient_oom"], err = phase_resilient_oom(torch, trimmed, dev, card)
        errs.append(err)
        launches["resilient_certify"], err = phase_resilient_certify(torch, trimmed, dev, card,
                                                                     log_root, cert_ref)
        errs.append(err)
        sticky, children = sticky_run.result(), chaos_run.result()
        sup = supervised.result()
    launches["resilient_sticky"], err = report_sticky(sticky, card)
    errs.append(err)
    launches["supervised_cct2"], err = report_supervised(torch, sup, card)
    errs.append(err)
    chaos_launches = phase_chaos(torch, card, log_root, children)
    return {"launches": launches, "chaos": chaos_launches, "err": max(errs)}


# -- the simulation service (slice 13b.1) --------------------------------------------


def _service_env() -> dict:
    import os

    root = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=str(root))


def _trace_records(path: Path) -> list:
    out = []
    if path.exists():
        for line in path.read_text().splitlines():
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def run_service_server(log_root: Path, device: str) -> dict:
    """The ``service_simulate`` and ``service_certify`` phases' server, a
    fresh interpreter (``examples/serve.py start`` on the card, nothing
    forked from this process): its start to its socket; SERVICE_REQUEST
    submitted twice under two ids (cold, then warm), then the first id
    again (the spool answers); the certify driver's ``--quick`` matrix
    through ``--via-service``; ``op: metrics``; a drain. Each submit's wall
    as the client sees it. Runs beside the main thread's phases: it only
    gathers."""
    from blades_tpu_torch.service.client import ServiceClient

    root = Path(__file__).resolve().parent
    out = log_root / "service_simulate"
    sock = out / "service.sock"
    log = open(log_root / "service_server.log", "w")
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "blades_tpu_torch.examples.serve", "start",
                             "--out", str(out), "--device", device, "--health-interval", "5"],
                            cwd=str(root),
                            env=_service_env(), stdout=subprocess.PIPE, stderr=log, text=True)
    run = {"t0": t0, "out": out, "walls": {}, "replies": {}}
    try:
        client = ServiceClient(str(sock), timeout=900, connect_retries=1)
        while True:
            try:
                client.ping()
                break
            except Exception:  # noqa: BLE001 - not listening yet
                check(proc.poll() is None and time.time() - t0 < 120,
                      "service: the server did not open its socket")
                time.sleep(0.01)
        run["socket_s"] = time.time() - t0
        for name, rid in (("cold", "svc-cold"), ("warm", "svc-warm"), ("resubmit", "svc-cold")):
            t = time.perf_counter()
            run["replies"][name] = client.submit(SERVICE_REQUEST, request_id=rid)
            run["walls"][name] = time.perf_counter() - t
        run["metrics_after_simulate"] = client.metrics()
        # the driver as a client process of its own (this thread must not
        # take over the script's standard output)
        t = time.perf_counter()
        cert = subprocess.run([sys.executable, "-m", "blades_tpu_torch.examples.certify",
                               *SERVICE_CERT_ARGS, "--via-service", str(sock), "--out",
                               str(log_root / "service_certify")], cwd=str(root),
                              env=_service_env(), capture_output=True, text=True, timeout=900)
        run["walls"]["certify"] = time.perf_counter() - t
        run["certify_rc"] = cert.returncode
        run["certify_summary"] = json.loads((cert.stdout.strip().splitlines() or ["{}"])[-1])
        run["metrics"] = client.metrics()
        run["drain"] = client.drain()
        stdout, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        log.close()
    run["rc"] = proc.returncode
    run["exit_line"] = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    run["trace"] = _trace_records(out / "service_trace.jsonl")
    cell_trace = _trace_records(out / "requests" / "svc-cold" / SERVICE_CELL["label"]
                                / "telemetry.jsonl")
    run["first_cell_meta_ts"] = next((r["ts"] for r in cell_trace if r.get("t") == "meta"),
                                     None)
    run["cell_spans"] = {rid: cell_spans(out / "requests" / rid / SERVICE_CELL["label"])
                         for rid in ("svc-cold", "svc-warm")}
    run["log"] = (log_root / "service_server.log").read_text()[-3000:]
    return run


def cell_spans(log_dir: Path) -> dict:
    """A served cell's Simulator trace: each round's wall (its ``round``
    spans) and the seconds by span path."""
    by_path, rounds = {}, []
    for r in _trace_records(log_dir / "telemetry.jsonl"):
        if r.get("t") == "span":
            by_path[r["path"]] = by_path.get(r["path"], 0.0) + r["dur_s"]
            if r["path"] == "round":
                rounds.append(r["dur_s"])
    return {"round_s": rounds, "by_path_s": by_path}


def _finished(trace: list) -> dict:
    return {r["id"]: r for r in trace if r.get("t") == "request" and r.get("event") == "finished"}


def report_service_simulate(run: dict, card: str) -> None:
    """``service_simulate``: the records and checks of the served main
    path (from :func:`run_service_server`)."""
    fin = _finished(run["trace"])
    started = {r["id"]: r["ts"] for r in run["trace"]
               if r.get("t") == "request" and r.get("event") == "started"}
    split = ("queue_wait_s", "build_s", "execute_s", "total_s", "warm", "compiles")
    cells = {n: run["replies"][n].get("cells") for n in ("cold", "warm")}
    resub = run["replies"]["resubmit"]
    m = run["metrics_after_simulate"]
    emit({"phase": "service_simulate", "request": SERVICE_CELL,
          "socket_s": run["socket_s"],
          "first_request_started_s": (started.get("svc-cold", run["t0"]) - run["t0"]),
          "first_cuda_s": (run["first_cell_meta_ts"] - run["t0"]
                           if run["first_cell_meta_ts"] else None),
          "requests": {rid: {k: fin[rid].get(k) for k in split}
                       for rid in ("svc-cold", "svc-warm") if rid in fin},
          "submit_wall_s": {n: run["walls"][n] for n in ("cold", "warm", "resubmit")},
          "cell_spans": run["cell_spans"],
          "served": resub.get("served"), "cells": cells["cold"],
          "metrics": {"requests": m.get("requests"), "split": m.get("split"),
                      "latency": m.get("latency"), "engine_cache": {
                          k: (m.get("engine_cache") or {}).get(k) for k in ("hits", "misses")}},
          "drain_rc": run["rc"], "card": card})
    check(run["replies"]["cold"].get("ok") and run["replies"]["warm"].get("ok"),
          f"service_simulate: {run['replies']['cold']} {run['replies']['warm']}\n{run['log']}")
    result = [c["result"] for c in cells["cold"]]
    check(cells["cold"] == cells["warm"] and result[0]["finite"],
          f"service_simulate: the warm reply differs: {cells}")
    check(fin["svc-cold"]["warm"] is False and fin["svc-warm"]["warm"] is True
          and fin["svc-warm"]["build_s"] == 0, f"service_simulate: cold/warm {fin}")
    check(resub.get("served") == "spool" and resub["reply"]["cells"] == cells["cold"]
          and m["requests"]["admitted"] == 2 and m["cells"]["done"] == 2,
          f"service_simulate: the resubmit ran again: {resub} {m['requests']}")
    check(run["rc"] == 0 and run["drain"].get("draining"),
          f"service_simulate: drain rc {run['rc']}\n{run['log']}")


def direct_service_cell(torch, dev, log_root: Path, dataset) -> dict:
    """SERVICE_CELL through a port ``Simulator`` built here (the service's
    defaults for what the cell leaves out) on ``dataset``, the service's
    seeded Synthetic store (its draws are keyed by the Simulator's seed,
    not by the store), hashed as the service hashes it."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.ops.pytree import ravel

    c = SERVICE_CELL
    sim = Simulator(dataset, aggregator=c["agg"], aggregator_kws=c["agg_kws"], attack=c["attack"],
                    num_byzantine=c["num_byz"], log_path=str(log_root / "service_direct"),
                    seed=c["seed"], device=dev)
    sim.run("mlp", global_rounds=c["rounds"], local_steps=1,
            train_batch_size=c["train_batch_size"], client_lr=0.2, server_lr=1.0,
            validate_interval=c["rounds"])
    params = ravel(sim.server.state.params, sim.engine.layout).detach().float().cpu().numpy()
    ev = sim.evaluate(c["rounds"], 64)
    return {"loss": round(float(ev["Loss"]), 6),
            "params_sha": hashlib.sha256(params.tobytes()).hexdigest()[:16]}


def phase_service_kernel(torch, trimmed, dev, card: str, log_root: Path) -> tuple:
    """``SimulationService(out, device="cuda")._execute`` of SERVICE_REQUEST
    twice in this process (the JAX package's ``tests/test_service.py:721``
    drive): the kernel's launches (3 a request), each held against the
    plain version; the reply's cell bit for bit a direct ``Simulator`` run
    of the payload here. Returns the launches, the largest error and the
    kernel timed on the first launch's input."""
    from blades_tpu_torch.service.server import SimulationService

    gc.collect()
    torch.cuda.synchronize()
    svc = SimulationService(str(log_root / "service_kernel"), device=str(dev))
    walls, replies = {}, {}
    try:
        trimmed.trimmed_mean_launches = 0
        with _HeldKernel(torch, trimmed, keep_first=True) as held:
            for rid in ("k-cold", "k-warm"):
                t = time.perf_counter()
                replies[rid] = svc._execute(rid, SERVICE_REQUEST)
                torch.cuda.synchronize()
                walls[rid] = time.perf_counter() - t
        launches = trimmed.trimmed_mean_launches
        (dataset,) = svc._datasets.values()
        spans = {rid: cell_spans(log_root / "service_kernel" / "requests" / rid
                                 / SERVICE_CELL["label"]) for rid in replies}
        split = {rid: {k: v for k, v in r.items() if k in ("queue_wait_s", "build_s",
                                                           "execute_s", "total_s", "warm")}
                 for rid, r in _finished(_trace_records(
                     log_root / "service_kernel" / "service_trace.jsonl")).items()}
    finally:
        svc.rec.close()
        svc.spool.close()
    n_held, err, bad = held.result()
    check(held.first is not None, f"service_kernel: no kernel launch in {replies}")
    x, b = held.first
    k, d = x.shape
    timings = kernel_timings(torch, trimmed, x, b)
    direct = direct_service_cell(torch, dev, log_root, dataset)
    cell = replies["k-cold"]["cells"][0].get("result", {})
    emit({"phase": "service_kernel", "launches": launches, "held": n_held,
          "max_abs_err": err, "elements_off_tol": bad, "wall_s": walls, "split": split,
          "cell_spans": spans,
          "cell": cell, "direct": direct, "shape_kdb": [k, d, b], **timings, "card": card})
    check(all(r.get("ok") for r in replies.values()), f"service_kernel: {replies}")
    check(launches == 2 * SERVICE_CELL["rounds"] and n_held == launches and bad == 0,
          f"service_kernel: {launches} launches, {n_held} held, {bad} elements off {TOL}")
    check(replies["k-cold"]["cells"] == replies["k-warm"]["cells"]
          and {n: cell.get(n) for n in ("loss", "params_sha")} == direct,
          f"service_kernel: the served cell {cell} is not the direct run's {direct}")
    check(split["k-cold"]["warm"] is False and split["k-warm"]["warm"] is True
          and split["k-warm"]["build_s"] == 0, f"service_kernel: cold/warm {split}")
    return launches, err, timings, {n: cell.get(n) for n in ("loss", "params_sha")}, direct


def report_service_certify(run: dict, ref: dict, device: str, card: str) -> None:
    """``service_certify``: the ``--via-service`` matrix against the
    in-process ``certify_matrix`` of the same spec on the card (``ref``):
    verdicts exact, ratios within CERT_TOL."""
    import numpy as np

    served = json.loads((Path(run["out"]).parent / "service_certify" / "cert_matrix.json")
                        .read_text())
    fin = _finished(run["trace"])
    rid = run["certify_summary"].get("id")
    same = all([(r["agg"], r["f"], r.get("scenario"), r["certified"]) for r in served[key]]
               == [(r["agg"], r["f"], r.get("scenario"), r["certified"])
                   for r in ref["matrix"][key]] for key in ("cells", "async_cells"))
    battery = ({n: {c: r["ok"] for c, r in b["contracts"].items()}
                for n, b in served["battery"].items()}
               == {n: {c: r["ok"] for c, r in b["contracts"].items()}
                   for n, b in ref["matrix"]["battery"].items()})
    ratios = [(a["worst_ratio"], b["worst_ratio"]) for key in ("cells", "async_cells")
              for a, b in zip(served[key], ref["matrix"][key])]
    worst = max((abs(a - b) - CERT_TOL["rtol"] * abs(b) for a, b in ratios), default=0.0)
    emit({"phase": "service_certify", "spec": list(SERVICE_CERT_ARGS), "id": rid,
          "cells": len(served["cells"]), "async_cells": len(served["async_cells"]),
          "verdicts_equal": same, "battery_equal": battery, "worst_ratio_excess": worst,
          "submit_wall_s": run["walls"]["certify"], "in_process_wall_s": ref["wall"],
          "split": {k: fin.get(rid, {}).get(k) for k in ("queue_wait_s", "build_s",
                                                         "execute_s", "total_s", "warm")},
          "device": served["device"], "card": card})
    check(run["certify_rc"] == 0 and run["certify_summary"]["ok"] and served["device"] == device,
          f"service_certify: {run['certify_summary']}")
    check(same and battery and np.allclose([a for a, _ in ratios], [b for _, b in ratios],
                                           **CERT_TOL),
          f"service_certify: the served matrix is not the in-process one (excess {worst})")


def certify_reference(torch, dev, log_root: Path) -> dict:
    """The in-process ``certify_matrix`` of SERVICE_CERT_ARGS on the card."""
    from blades_tpu_torch.examples import certify

    args = certify.parse_args([*SERVICE_CERT_ARGS, "--out", str(log_root / "service_cert_ref")])
    t0 = time.perf_counter()
    matrix = certify.certify_matrix(args, device=dev)
    torch.cuda.synchronize()
    return {"matrix": matrix, "wall": time.perf_counter() - t0}


def phase_service_chaos(drills: dict, card: str, log_root: Path) -> None:
    """``service_chaos``: the reduced drills, the pool's ``worker_crash``
    and ``worker_hang``, and the supervised SIGKILL resume
    (``examples/chaos.py:service_chaos(full=True)``) against servers
    started on this machine (probe cells: no server or worker imports
    torch); every pool shut down with no survivor."""
    rows = {r["name"]: r for r in drills["summary"]["scenarios"]}
    kill = rows.get("sigkill_resume", {})
    shutdowns = {p.parent.name: [r["survivors"] for r in _trace_records(p)
                                 if r.get("event") == "pool_shutdown"]
                 for p in sorted((log_root / "service_chaos").glob("w*/service_trace.jsonl"))}
    emit({"phase": "service_chaos", "ok": drills["summary"]["ok"],
          "failed": [n for n, r in rows.items() if not r["ok"]],
          "scenarios": drills["summary"]["scenarios"], "pool_survivors": shutdowns,
          "wall_s": drills["wall"], "card": card})
    check(drills["summary"]["ok"] and len(rows) == 9 and kill.get("content_identical")
          and kill.get("resumed_skipped") == 2 and kill.get("executed") == 2,
          f"service_chaos: {drills['summary']}")
    check(set(shutdowns) == {"wcrash_ref", "wcrash", "whang"}
          and all(s == [[]] for s in shutdowns.values()),
          f"service_chaos: the pools' survivors {shutdowns}")


def run_service_drills(log_root: Path) -> dict:
    """The service drills, gathered only (they start their own servers)."""
    from blades_tpu_torch.examples import chaos

    t0 = time.perf_counter()
    summary = chaos.service_chaos(str(log_root / "service_chaos"), full=True)
    return {"summary": summary, "wall": time.perf_counter() - t0}


def service_phases(torch, trimmed, dev, card: str, log_root: Path,
                   pool_only: bool = False) -> dict:
    """The slice 13b phases: the server subprocess (``service_simulate``,
    then ``service_certify``'s request), the pool's servers
    (``pool_simulate`` and ``pool_sticky``, then ``pool_deadline`` beside
    them) and the drills' servers run in threads beside this process's
    ``service_kernel`` and the certify reference; the records and checks
    are made here after. ``pool_only`` leaves out ``service_simulate``,
    ``service_certify`` and the certify reference. Returns the launches in
    this process and in the pool's workers, the largest error and the
    kernel's timings."""
    from concurrent.futures import ThreadPoolExecutor

    # the threads' first imports of these, side by side, can deadlock on
    # the import lock: made here first
    import blades_tpu_torch.examples.certify  # noqa: F401
    import blades_tpu_torch.examples.chaos  # noqa: F401
    import blades_tpu_torch.service.client  # noqa: F401
    import blades_tpu_torch.service.server  # noqa: F401
    import blades_tpu_torch.service.spool  # noqa: F401
    import blades_tpu_torch.supervision.supervisor  # noqa: F401
    import blades_tpu_torch.sweeps.journal  # noqa: F401

    with ThreadPoolExecutor(max_workers=3) as threads:
        server = None if pool_only else threads.submit(run_service_server, log_root, str(dev))
        pool = threads.submit(run_pool, torch, log_root)
        drills = threads.submit(run_service_drills, log_root)
        launches, err, timings, cell, direct = phase_service_kernel(torch, trimmed, dev, card,
                                                                    log_root)
        ref = None if pool_only else certify_reference(torch, dev, log_root)
        run = None if pool_only else server.result()
        pooled = pool.result()
        drill = drills.result()
    if not pool_only:
        report_service_simulate(run, card)
        report_service_certify(run, ref, str(dev), card)
    pool_launches = report_pool(pooled, cell, direct, card)
    phase_service_chaos(drill, card, log_root)
    errs = [f["max_abs_err"] for r in (pooled["simulate"], *pooled["deadline"], pooled["sticky"])
            for f in r["held_files"]]
    return {"launches": launches, "pool_launches": pool_launches,
            "err": max([err, *errs]), "timings": timings}


# -- the worker pool (slice 13b.2) ---------------------------------------------------
# Servers started as the drills start them (examples/serve.py start --workers N
# --device cuda), in threads beside the in-process phases: they only gather,
# and the records and checks are made on the main thread after.

#: written into the pool servers' PYTHONPATH (and so their workers'): in a
#: worker each trimmed-mean launch is held against the plain version, the
#: counts written at the worker's exit; CHIP_POOL_STICKY arms, once, the
#: kernel's raw entry on an address nothing owns before a launch
POOL_SITE = r'''"""chip_smoke.py's hold of the trimmed-mean kernel in pool workers."""
import atexit
import importlib.machinery
import importlib.util
import json
import os
import sys
import threading
import time


def _install(mod):
    import torch

    orig, errs, bad = mod.trimmed_mean_cuda, [], []
    sticky = os.environ.get("CHIP_POOL_STICKY")

    def held(x, b):
        if sticky and not os.path.exists(sticky):
            open(sticky, "w").close()
            out = torch.empty(1 << 20, device="cuda")
            mod._library().blades_trimmed_mean_f32(16, out.data_ptr(), 8, 1 << 20, 1,
                                                   torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()  # the illegal address surfaces here
        out = orig(x, b)
        ref = mod.trimmed_mean_plain(x, b)
        errs.append((out - ref).abs().max())
        bad.append((~torch.isclose(out, ref, rtol=1e-5, atol=1e-5)).sum())
        return out

    def watch_memory():
        # the worker's allocator, 4 times a second once CUDA is up: a
        # killed worker leaves its last reading
        path = os.path.join(os.environ["CHIP_POOL_HELD_DIR"], f"mem-{os.getpid()}.jsonl")
        while True:
            if torch.cuda.is_initialized():
                with open(path, "a") as fh:
                    fh.write(json.dumps({"ts": time.time(),
                                         "reserved": torch.cuda.memory_reserved(),
                                         "allocated": torch.cuda.memory_allocated()}) + "\n")
            time.sleep(0.25)

    threading.Thread(target=watch_memory, daemon=True).start()

    def report():
        from blades_tpu_torch.telemetry import programs, recorder

        rec = {"pid": os.getpid(), "worker": os.environ.get("BLADES_WORKER_ID"),
               "reserved": torch.cuda.memory_reserved(),
               "peak_reserved": torch.cuda.max_memory_reserved(),
               "launches": mod.trimmed_mean_launches, "held": len(errs),
               "max_abs_err": float(torch.stack(errs).max()) if errs else 0.0,
               "elements_off_tol": int(torch.stack(bad).sum()) if bad else 0,
               "counters": recorder.process_counters(), "programs": programs.snapshot()}
        path = os.path.join(os.environ["CHIP_POOL_HELD_DIR"], f"held-{os.getpid()}.json")
        with open(path, "w") as fh:
            json.dump(rec, fh)

    mod.trimmed_mean_cuda = held
    atexit.register(report)


class _Hook:
    def find_spec(self, name, path, target=None):
        if name != "blades_tpu_torch.ops.trimmed":
            return None
        sys.meta_path.remove(self)
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            _install(module)

        spec.loader.exec_module = exec_module
        return spec


if os.environ.get("BLADES_WORKER_ID") and os.environ.get("CHIP_POOL_HELD_DIR"):
    sys.meta_path.insert(0, _Hook())
# another sitecustomize further down the path still runs
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None and _spec.loader is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''
POOL_TIMEOUT_S = 600
#: the pool_simulate phase's second body, which worker B takes cold
POOL_OTHER_CELL = {**SERVICE_CELL, "label": "other", "seed": 2}
#: pool_deadline's first server's cell deadline: a cold worker's first cell
#: takes more
POOL_DEADLINE_S = 2.0
#: the program scopes that a Simulator round opens (``datasets/fl.py``, the
#: engine's ``run_round``): the first record of each is the first round's
ROUND_SCOPES = ("dataset/sample_round", "engine/round")


def _worker_mem(run: dict, pid: int, before: float = None) -> dict:
    """A worker's own allocator readings (POOL_SITE): its last reserved
    and allocated bytes (before ``before``), or zeros if CUDA never came
    up in it."""
    recs = [r for r in run["mem"].get(pid, []) if before is None or r["ts"] <= before]
    last = recs[-1] if recs else {}
    return {"reserved_gb": last.get("reserved", 0) / 1e9,
            "allocated_gb": last.get("allocated", 0) / 1e9, "readings": len(recs)}


def maps_torch(pid: int) -> bool:
    """Whether process ``pid`` has torch's library mapped."""
    try:
        return "libtorch" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False


def start_pool(log_root: Path, name: str, args: tuple, env_extra: dict = None) -> dict:
    """``examples/serve.py start --device cuda`` with ``args``, its
    workers' PYTHONPATH headed by POOL_SITE; returns once its socket
    answers and every worker is ready."""
    import os

    from blades_tpu_torch.service.client import ServiceClient

    root = Path(__file__).resolve().parent
    site = log_root / "pool_site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(POOL_SITE)
    held = log_root / "pool_held" / name
    held.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(site), str(root)]),
               CHIP_POOL_HELD_DIR=str(held), **BESIDE_ENV, **(env_extra or {}))
    out = log_root / name
    log = open(log_root / f"{name}.log", "w")
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "blades_tpu_torch.examples.serve", "start",
                             "--out", str(out), "--device", "cuda", "--health-interval", "5",
                             *args], cwd=str(root), env=env, stdout=subprocess.PIPE,
                            stderr=log, text=True)
    client = ServiceClient(str(out / "service.sock"), timeout=POOL_TIMEOUT_S, connect_retries=1)
    run = {"name": name, "proc": proc, "client": client, "out": out, "held": held, "log": log,
           "t0": t0}
    while True:
        try:
            st = client.status()
            if st["workers"]["idle"] == st["workers"]["size"]:
                break
        except Exception:  # noqa: BLE001 - not listening yet
            pass
        check(proc.poll() is None and time.time() - t0 < 120,
              f"{name}: the server or its workers did not start")
        time.sleep(0.02)
    run["ready_s"] = time.time() - t0
    run["pids"] = {w: b["pid"] for w, b in st["workers"]["by_worker"].items()}
    return run


def stop_pool(run: dict) -> dict:
    """Drain, reap, and gather the trace, the held files and the workers'
    stderr."""
    try:
        run["drain"] = run["client"].drain()
        stdout, _ = run["proc"].communicate(timeout=300)
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
            stdout, _ = run["proc"].communicate()
        run["log"].close()
    run["rc"] = run["proc"].returncode
    run["exit_line"] = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    run["trace"] = _trace_records(run["out"] / "service_trace.jsonl")
    run["held_files"] = [json.loads(p.read_text()) for p in sorted(run["held"].glob("*.json"))]
    run["mem"] = {int(p.stem[4:]): _trace_records(p) for p in run["held"].glob("mem-*.jsonl")}
    run["worker_err"] = {p.stem: p.read_text()[-2000:]
                         for p in sorted((run["out"] / "workers").glob("*.err"))}
    run["server_log"] = (run["out"].parent / f"{run['name']}.log").read_text()[-3000:]
    for key in ("proc", "client", "log"):
        run.pop(key)
    return run


def _worker_events(trace: list, event: str) -> list:
    return [r for r in trace if r.get("t") == "worker" and r.get("event") == event]


def _spawn_to_ready(trace: list) -> dict:
    """Each worker's seconds from its spawn (or replace) record to its
    ready record."""
    born = {r["worker"]: r["ts"] for r in trace if r.get("t") == "worker"
            and r.get("event") in ("spawn", "replace")}
    return {r["worker"]: r["ts"] - born[r["worker"]] for r in _worker_events(trace, "ready")
            if r["worker"] in born}


def _program_records(out: Path, rid: str, label: str) -> list:
    return [r for r in _trace_records(out / "requests" / rid / label / "telemetry.jsonl")
            if r.get("t") == "program"]


def run_pool_simulate(log_root: Path) -> dict:
    """``pool_simulate``'s server (``--workers 2``): SERVICE_REQUEST cold
    on worker A, then at once its repeat (the affinity route: A, warm) and
    a second body (B, cold); the workers' device memory idle and warm and
    whether torch was mapped before the first request."""
    run = start_pool(log_root, "pool_simulate", ("--workers", "2"))
    client = run["client"]
    try:
        run["torch_before"] = {w: maps_torch(p) for w, p in run["pids"].items()}
        walls, replies = {}, {}
        t = time.perf_counter()
        replies["cold"] = client.submit(SERVICE_REQUEST, request_id="pool-cold")
        walls["cold"] = time.perf_counter() - t

        def submit(name, request, rid):
            t = time.perf_counter()
            replies[name] = client.submit(request, request_id=rid)
            walls[name] = time.perf_counter() - t

        import threading

        warm = threading.Thread(target=submit, args=("warm", SERVICE_REQUEST, "pool-warm"))
        warm.start()
        while True:  # the repeat is on its worker before the other body is sent
            by = client.status()["workers"]["by_worker"]
            if any(b.get("request") == "pool-warm" for b in by.values()) or not warm.is_alive():
                break
            time.sleep(0.005)
        submit("other", {"kind": "simulate", "cells": [POOL_OTHER_CELL]}, "pool-other")
        warm.join()
        run["warm_ts"] = time.time()
        run["torch_after"] = {w: maps_torch(p) for w, p in run["pids"].items()}
        run.update(walls=walls, replies=replies, metrics=client.metrics())
    finally:
        stop_pool(run)
    run["programs"] = {rid: _program_records(run["out"], rid, label) for rid, label in (
        ("pool-cold", SERVICE_CELL["label"]), ("pool-warm", SERVICE_CELL["label"]),
        ("pool-other", POOL_OTHER_CELL["label"]))}
    run["cell_spans"] = {rid: cell_spans(run["out"] / "requests" / rid / label)
                         for rid, label in (("pool-cold", "main"), ("pool-warm", "main"),
                                            ("pool-other", "other"))}
    return run


def _sample_memory(torch, client, until, samples: list, period: float = 0.25) -> None:
    """(time, the card's free bytes) every ``period`` seconds until
    ``until(status)``."""
    t_end = time.time() + POOL_TIMEOUT_S
    while time.time() < t_end:
        st = client.status()
        samples.append((time.time(), torch.cuda.mem_get_info()[0]))
        if until(st):
            return
        time.sleep(period)


def _killed(torch, client, rid: str, request: dict, kills: int) -> tuple:
    """Submit ``request`` as ``rid`` and sample the card's memory until the
    pool's ``kills``-th kill and 5 s after it; ``(samples, reply)``."""
    samples, killed = [], []
    client.submit(request, request_id=rid, wait=False)

    def until(st):
        if not killed and st["workers"]["kills"] >= kills:
            killed.append(time.time())
        return bool(killed) and time.time() - killed[0] > 5.0
    _sample_memory(torch, client, until, samples)
    return samples, client.wait_result(rid, timeout=POOL_TIMEOUT_S)["reply"]


def run_pool_deadline(torch, log_root: Path, name: str, rid: str, deadline: float) -> dict:
    """A ``pool_deadline`` server (``--workers 1 --cell-deadline deadline
    --attempts 1``): a cold SERVICE_REQUEST as ``rid``, its worker killed
    by the parent in its first cell, the card's memory sampled around the
    kill; then a probe request on the replacement."""
    run = start_pool(log_root, name, ("--workers", "1", "--cell-deadline", str(deadline),
                                      "--attempts", "1"))
    client = run["client"]
    try:
        (run["pid0"],) = run["pids"].values()
        run["samples"], run["reply"] = _killed(torch, client, rid, SERVICE_REQUEST, 1)
        run["probe"] = client.submit({"kind": "probe", "cells": [{"label": "p", "op": "ok"}]},
                                     request_id=f"{rid}-probe")
        run["status"] = client.status()
    finally:
        stop_pool(run)
    run.update(rid=rid, deadline=deadline)
    return run


def run_pool_sticky(torch, log_root: Path) -> dict:
    """``pool_sticky``'s server (``--workers 1 --attempts 2``) with
    CHIP_POOL_STICKY: SERVICE_REQUEST whose worker's context dies at its
    first launch; the card's memory sampled until the reply."""
    sentinel = log_root / "pool_sticky.fired"
    run = start_pool(log_root, "pool_sticky", ("--workers", "1", "--attempts", "2"),
                     {"CHIP_POOL_STICKY": str(sentinel)})
    client = run["client"]
    (pid0,) = run["pids"].values()
    samples = []
    try:
        t = time.perf_counter()
        client.submit(SERVICE_REQUEST, request_id="st-1", wait=False)
        _sample_memory(torch, client, lambda st: st.get("served", 0) >= 1, samples)
        run["reply"] = client.wait_result("st-1", timeout=POOL_TIMEOUT_S)["reply"]
        run["wall"] = time.perf_counter() - t
        run["status"] = client.status()
    finally:
        stop_pool(run)
    run.update(pid0=pid0, samples=samples, fired=sentinel.exists())
    return run


def cuda_deadline(sim: dict) -> float:
    """pool_deadline_cuda's cell deadline, from pool_simulate's cold request
    on this machine: the seconds from its start to its worker's first
    reserved bytes, plus half its first round, less the parent's slack.
    The kill then lands in a cold worker's first round, its CUDA work
    under way, however slow the host is."""
    from blades_tpu_torch.service.server import DEADLINE_SLACK_S

    started = next(r["ts"] for r in sim["trace"] if r.get("t") == "request"
                   and r.get("event") == "started" and r.get("id") == "pool-cold")
    pid = sim["pids"][_finished(sim["trace"])["pool-cold"]["worker"]]
    first = next((r["ts"] for r in sim["mem"].get(pid, [])
                  if r["ts"] >= started and r["reserved"] > 0), None)
    check(first is not None and sim["cell_spans"]["pool-cold"]["round_s"],
          "pool_deadline: pool_simulate's cold request has no CUDA reading or round")
    first_round = sim["cell_spans"]["pool-cold"]["round_s"][0]
    return round(first - started + first_round / 2 - DEADLINE_SLACK_S, 1)


def run_pool(torch, log_root: Path) -> dict:
    """The pool phases' servers: pool_simulate then pool_sticky in one
    thread, pool_deadline's two in another, the second once pool_simulate
    has given its deadline."""
    from concurrent.futures import Future, ThreadPoolExecutor

    simulated = Future()

    def deadlines():
        cold = run_pool_deadline(torch, log_root, "pool_deadline", "dl-cold", POOL_DEADLINE_S)
        return [cold, run_pool_deadline(torch, log_root, "pool_deadline_cuda", "dl-cuda",
                                        cuda_deadline(simulated.result()))]

    with ThreadPoolExecutor(max_workers=1) as side:
        deadline = side.submit(deadlines)
        try:
            simulate = run_pool_simulate(log_root)
        except BaseException as e:
            simulated.set_exception(e)
            raise
        simulated.set_result(simulate)
        sticky = run_pool_sticky(torch, log_root)
        return {"simulate": simulate, "deadline": deadline.result(), "sticky": sticky}


def _held_total(run: dict) -> tuple:
    """(launches, held, largest error, elements off TOL) of a server's
    workers that exited cleanly."""
    files = run["held_files"]
    return (sum(f["launches"] for f in files), sum(f["held"] for f in files),
            max((f["max_abs_err"] for f in files), default=0.0),
            sum(f["elements_off_tol"] for f in files))


def _cell_of(reply: dict) -> dict:
    cells = reply.get("cells") or [{}]
    return {k: (cells[0].get("result") or {}).get(k) for k in ("loss", "params_sha")}


def _builds(records: list) -> list:
    return [r for r in records if r["outcome"] != "warm-reuse"]


def report_pool_simulate(run: dict, service_cell: dict, direct: dict, card: str) -> int:
    """``pool_simulate``: the records and checks; returns the launches in
    its workers."""
    fin = _finished(run["trace"])
    split = ("queue_wait_s", "build_s", "execute_s", "total_s", "warm", "compiles", "worker")
    launches, n_held, err, bad = _held_total(run)
    by_pid = {f["pid"]: f for f in run["held_files"]}
    a = fin["pool-cold"]["worker"]
    held_a = by_pid.get(run["pids"][a], {})
    counters = held_a.get("counters", {})
    builds = _builds(run["programs"]["pool-cold"])
    tiled = {"trace_s": sum(r.get("trace_s", 0.0) for r in builds),
             "compile_s": sum(r.get("compile_s", 0.0) for r in builds),
             "compiles": sum(r.get("compiles", 0) for r in builds),
             "cache_hits": sum(r.get("cache_hits", 0) for r in builds)}
    mirror = {"trace_s": counters.get("cuda.graph_capture_s", 0.0),
              "compile_s": counters.get("cuda.kernel_build_s", 0.0),
              "compiles": counters.get("cuda.kernel_builds", 0)
              + counters.get("cuda.graph_captures", 0),
              "cache_hits": counters.get("cuda.kernel_reuses", 0)}
    spans = run["cell_spans"]["pool-cold"]
    first_round = spans["round_s"][0] if spans["round_s"] else None
    # the first round's own build records: the first of each scope it opens
    in_round = [next((r for r in run["programs"]["pool-cold"] if r["program"] == p), {})
                for p in ROUND_SCOPES]
    explained = sum(r.get("trace_s", 0.0) + r.get("compile_s", 0.0) for r in in_round)
    emit({"phase": "pool_simulate", "request": SERVICE_CELL, "other": POOL_OTHER_CELL,
          "workers_ready_s": run["ready_s"], "spawn_to_ready_s": _spawn_to_ready(run["trace"]),
          "torch_before_first_simulate": run["torch_before"],
          "torch_after": run["torch_after"],
          "requests": {rid: {k: fin[rid].get(k) for k in split} for rid in fin},
          "submit_wall_s": run["walls"],
          "mem_idle": {w: _worker_mem(run, p, run["t0"] + run["ready_s"])
                       for w, p in run["pids"].items()},
          "mem_warm": {w: _worker_mem(run, p, run["warm_ts"]) for w, p in run["pids"].items()},
          "program_records": run["programs"], "cold_build_records_tiled": tiled,
          "worker_a_counters": mirror, "worker_a_unattributed":
              held_a.get("programs", {}).get("unattributed"),
          "cell_spans": run["cell_spans"], "first_round_s": first_round,
          "first_round_records": in_round, "first_round_explained_s": explained,
          "first_round_unexplained_share": (1 - explained / first_round) if first_round
          else None,
          "held": run["held_files"], "launches": launches, "max_abs_err": err,
          "cell": _cell_of(run["replies"]["cold"]), "service_kernel_cell": service_cell,
          "direct": direct, "drain_rc": run["rc"], "card": card})
    check(all(r.get("ok") for r in run["replies"].values()),
          f"pool_simulate: {run['replies']}\n{run['server_log']}\n{run['worker_err']}")
    check(not any(run["torch_before"].values()), "pool_simulate: torch before a simulate")
    check(fin["pool-warm"]["worker"] == a and fin["pool-other"]["worker"] != a,
          f"pool_simulate: routing {[(r, fin[r]['worker']) for r in fin]}")
    check(fin["pool-cold"]["warm"] is False and fin["pool-other"]["warm"] is False
          and fin["pool-warm"]["warm"] is True and fin["pool-warm"]["build_s"] == 0,
          f"pool_simulate: cold/warm {fin}")
    check(_cell_of(run["replies"]["cold"]) == _cell_of(run["replies"]["warm"]) == service_cell
          == direct, f"pool_simulate: the served cell {_cell_of(run['replies']['cold'])} is "
          f"not service_kernel's {service_cell} or the direct run's {direct}")
    check(len(run["held_files"]) == 2
          and launches == n_held == len(run["replies"]) * SERVICE_CELL["rounds"]
          and bad == 0 and all(f["launches"] == f["held"] for f in run["held_files"]),
          f"pool_simulate: {run['held_files']}")
    check(not _builds(run["programs"]["pool-warm"]) and builds
          and all(abs(tiled[k] - mirror[k]) < 1e-6 for k in tiled),
          f"pool_simulate: build records {tiled} against the worker's counters {mirror}; "
          f"warm {run['programs']['pool-warm']}")
    check(run["rc"] == 0, f"pool_simulate: drain rc {run['rc']}\n{run['server_log']}")
    return launches


def _memory_of(run: dict, event_ts: float) -> dict:
    """Around a worker's death at ``event_ts``: its own last allocator
    reading, whether its process is gone, the card's free memory at the
    last sample before and each sample after, and the seconds until the
    card's free memory rose by 90% of the worker's reserved bytes."""
    import os

    samples = run["samples"]
    before = [s for s in samples if s[0] <= event_ts]
    after = [s for s in samples if s[0] > event_ts]
    free0 = before[-1][1] if before else None
    worker = _worker_mem(run, run["pid0"], event_ts)
    gain = worker["reserved_gb"] * 1e9
    back = next((t for t, f in after
                 if free0 is not None and gain > 0 and f - free0 >= 0.9 * gain), None)
    return {"worker": worker,
            "freed_gb": (max(f for _, f in after) - free0) / 1e9
            if after and free0 is not None else None,
            "process_gone": not os.path.exists(f"/proc/{run['pid0']}"),
            "card_free_gb_before": free0 / 1e9 if free0 is not None else None,
            "after": [[round(t - event_ts, 3), f / 1e9] for t, f in after],
            "back_after_s": (back - event_ts) if back else None}


def report_pool_deadline(runs: list, card: str) -> int:
    """``pool_deadline``: the records and checks of its two servers;
    returns the launches held in their workers (none: the killed ones'
    are lost with them, and the replacements serve only probes)."""
    out, total = {}, 0
    for run in runs:
        trace, rid = run["trace"], run["rid"]
        kills = _worker_events(trace, "kill")
        mem = _memory_of(run, kills[0]["ts"] if kills else time.time())
        fin = _finished(trace)
        launches, n_held, _, _ = _held_total(run)
        total += launches
        out[run["name"]] = {
            "cell_deadline_s": run["deadline"], "kill": kills, "memory": mem,
            "spawn_to_ready_s": _spawn_to_ready(trace), "quarantined_reply": run["reply"],
            "probe_ok": run["probe"].get("ok"),
            "requests": {r: {k: v.get(k) for k in ("outcome", "worker", "warm", "total_s")}
                         for r, v in fin.items()},
            "restarts": run["status"]["workers"]["restarts"], "drain_rc": run["rc"]}
        name = f"pool_deadline ({run['name']})"
        check(len(kills) == 1 and kills[0].get("request") == rid
              and kills[0].get("cell") == SERVICE_CELL["label"]
              and kills[0]["reason"] == "deadline", f"{name}: kills {kills}\n{run['server_log']}")
        cells = run["reply"].get("cells") or [{}]
        check(run["reply"].get("status") == "done" and cells[0].get("quarantined")
              and cells[0].get("error_type") == "CellDeadlineExceeded",
              f"{name}: {rid} {run['reply']}")
        check(mem["process_gone"], f"{name}: the killed worker lives on: {mem}")
        check(run["probe"].get("ok") and fin.get(f"{rid}-probe", {}).get("outcome") == "ok"
              and [r for r, v in fin.items() if v.get("outcome") == "quarantined"] == [rid]
              and run["status"]["workers"]["restarts"] == 1,
              f"{name}: only the killed request is quarantined, the replacement serves: {fin}")
        check(launches == n_held == 0, f"{name}: {run['held_files']}")
        check(run["rc"] == 0, f"{name}: drain rc {run['rc']}\n{run['server_log']}")
    cuda = out["pool_deadline_cuda"]
    check(cuda["memory"]["worker"]["reserved_gb"] > 0,
          f"pool_deadline: the {cuda['cell_deadline_s']} s kill came before any CUDA work: "
          f"{cuda['memory']['worker']}")
    emit({"phase": "pool_deadline", "servers": out, "card": card})
    return total


def report_pool_sticky(run: dict, service_cell: dict, card: str) -> int:
    """``pool_sticky``: the records and checks; returns the launches held
    in the replacement."""
    trace = run["trace"]
    crashes = _worker_events(trace, "crash")
    crash_ts = crashes[0]["ts"] if crashes else time.time()
    mem = _memory_of(run, crash_ts)
    reply = run["reply"]
    launches, n_held, err, bad = _held_total(run)
    emit({"phase": "pool_sticky", "fired": run["fired"], "crash": crashes,
          "restarts": run["status"]["workers"]["restarts"], "summary": reply.get("summary"),
          "cell": _cell_of(reply), "wall_s": run["wall"], **mem,
          "spawn_to_ready_s": _spawn_to_ready(trace),
          "dead_worker_err": run["worker_err"].get("w0", "")[-600:],
          "held": run["held_files"], "launches": launches, "max_abs_err": err,
          "drain_rc": run["rc"], "card": card})
    check(run["fired"] and len(crashes) == 1 and crashes[0].get("request") == "st-1"
          and "DeviceLost" in run["worker_err"].get("w0", ""),
          f"pool_sticky: {crashes}\n{run['worker_err']}\n{run['server_log']}")
    check(reply.get("ok") and _cell_of(reply) == service_cell
          and run["status"]["workers"]["restarts"] == 1
          and reply["summary"]["quarantined"] == [],
          f"pool_sticky: {reply} {run['status']['workers']}")
    check(len(run["held_files"]) == 1 and launches == n_held == SERVICE_CELL["rounds"]
          and bad == 0,
          f"pool_sticky: {run['held_files']}")
    check(mem["process_gone"] and mem["worker"]["reserved_gb"] > 0,
          f"pool_sticky: the dead worker lives on, or never held memory: {mem}")
    check(run["rc"] == 0, f"pool_sticky: drain rc {run['rc']}\n{run['server_log']}")
    return launches


def report_pool(pool: dict, service_cell: dict, direct: dict, card: str) -> int:
    """The pool phases' records and checks; the launches held in workers."""
    return (report_pool_simulate(pool["simulate"], service_cell, direct, card)
            + report_pool_deadline(pool["deadline"], card)
            + report_pool_sticky(pool["sticky"], service_cell, card))


# -- the reference CLI and the JAX examples (slice 15a) --------------------------------
# The drivers under blades_tpu_torch/examples/ run through their own main(argv)
# in this process, in a working directory of their own, the card's numerics
# as each driver sets them (utils/platform.py:apply_numerics) and put back
# after; every kernel launch held against the plain version.

#: the CLI's CCT-2 run: the reference recipe (K=20, f=8 ALIE, trimmed mean
#: b=8, Adam persisting, 50 local steps of batch 32) on CIFAR-10 files of
#: the published layout, DRIVERS_CLI_ROUNDS rounds with validation each round
DRIVERS_CLI_ROUNDS, DRIVERS_CLI_STEPS = 3, 50
DRIVERS_CLI_ARGV = ("--model", "cct", "--agg", "trimmedmean", "--attack", "alie",
                    "--num_clients", "20", "--num_byzantine", "8",
                    "--local_round", str(DRIVERS_CLI_STEPS),
                    "--batch_size", "32", "--global_round", str(DRIVERS_CLI_ROUNDS),
                    "--log_interval", "1")
DRIVERS_CLI_SHAPE = (20, 283_723, 8)
#: config 1's rounds on the card (of 50 local steps, in each of its 3 runs;
#: 100 in the example, 57 s on the H100; 30, 17.6-34.2 s; 10, 10.8 s): the
#: runs, the kernel once a round and finite losses hold at any depth; the
#: accuracies after 100 rounds (0.888, 0.876 and 0.871 on the H100) are not
#: shown at 5
DRIVERS_CONFIG1_ROUNDS = 5
#: customize_attack's rounds on the card (50 of 50 local steps in the
#: example, 15.5 s on the H100; 10, 7.7 s): its claim, a finite run with
#: the registered attackers, holds at any depth
DRIVERS_ATTACK_ROUNDS = 5
#: the robustness matrix's sub-grid on the card: the kernel's column under
#: every attack (its expectations checked cell by cell)
DRIVERS_MATRIX_AGGS = ("trimmedmean",)
#: the other examples, in the order run, with their argv (their own
#: settings; each runs in a working directory of its own, so "out" is its)
DRIVERS_EXAMPLES = (
    ("simulation_on_mnist", ("--data-root", "no_data", "--out", "out")),
    ("robustness_matrix", ("--aggs", *DRIVERS_MATRIX_AGGS, "--out", "out")),
    ("customize_aggregator", ()),
    ("customize_attack", ("--synthetic",)),
    ("fltrust_example", ()),
    ("fault_injection", ("--out", "out")),
    ("streaming_clients", ("--out", "out")),
    ("async_fedbuff", ("--out", "out")),
    ("metrics_trace", ("--out", "out")),
)
#: the examples whose runs reach the kernel (the dense trimmed mean)
DRIVERS_ON_KERNEL = ("simulation_on_mnist", "robustness_matrix", "streaming_clients")


class _Numerics:
    """cuDNN's deterministic switch saved on entry and put back on exit: each
    driver turns it on for its process (``apply_numerics``, which also sets
    the other three switches as the script keeps them: cuDNN's benchmark
    search and TF32 off)."""

    def __enter__(self):
        from blades_tpu_torch.utils.platform import numerics

        self.deterministic = numerics()["cudnn_deterministic"]
        return self

    def __exit__(self, *exc):
        from blades_tpu_torch.utils.platform import set_numerics

        set_numerics(cudnn_deterministic=self.deterministic)
        return False


def round_spans(trace: Path) -> list:
    """Each round's spans from a run's telemetry trace: the ``round`` span's
    seconds and its children's (``sample``, ``dispatch``, ``sync``,
    ``eval``), by name."""
    out, cur = [], {}
    for line in trace.read_text().splitlines():
        r = json.loads(line)
        if r.get("t") != "span" or not r["path"].startswith("round"):
            continue
        head, _, child = r["path"].partition("/")
        if head != "round":
            continue
        if child:
            cur[child] = cur.get(child, 0.0) + r["dur_s"]
        else:
            out.append({**cur, "round": r["dur_s"]})
            cur = {}
    return out


def phase_drivers_cli(torch, trimmed, dev, card: str, log_root: Path) -> tuple:
    """``drivers_cli_cifar10``: ``examples/cifar10.py``'s ``main`` on
    CIFAR-10 files (``write_cifar10``) with DRIVERS_CLI_ARGV and no
    ``--device`` (the card): the cold and warm rounds, each round's spans
    from the run's telemetry trace (the local steps' seconds are the round
    less its validation), the peak memory, one launch a round, each held
    against the plain version; the kernel timed
    at the round's ``[20, 283723]``, b=8, on the first launch's input.
    Returns the launches, the largest error and the timings."""
    import contextlib

    from blades_tpu_torch.examples import cifar10
    from blades_tpu_torch.utils.logging import read_stats
    from blades_tpu_torch.utils.platform import numerics

    base = log_root / "drivers_cli"
    t0 = time.perf_counter()
    write_cifar10(base / "data")
    write_s = time.perf_counter() - t0

    class Timed(cifar10.Simulator):
        def run(self, *a, **kw):
            self.round_s = super().run(*a, **kw)
            return self.round_s

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    saved, cifar10.Simulator = cifar10.Simulator, Timed
    try:
        trimmed.trimmed_mean_launches = 0
        with _Numerics(), contextlib.chdir(base), \
                _HeldKernel(torch, trimmed, keep_first=True) as held:
            t0 = time.perf_counter()
            sim = cifar10.main(list(DRIVERS_CLI_ARGV))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            during = numerics()
        launches = trimmed.trimmed_mean_launches
    finally:
        cifar10.Simulator = saved
    peak = torch.cuda.max_memory_allocated()
    log_dir = base / cifar10.parse_arguments(list(DRIVERS_CLI_ARGV)).log_dir
    train, test = read_stats(str(log_dir), "train"), read_stats(str(log_dir), "test")
    spans = round_spans(log_dir / "telemetry.jsonl")
    # the local steps' share of each round: the round without its validation
    steps_s = [r["round"] - r.get("eval", 0.0) for r in spans]
    n_held, err, bad = held.result()
    x, b = held.first
    k, d = x.shape
    timings = kernel_timings(torch, trimmed, x, b)
    # ALIE's f=8 identical rows tie in every column; the same shape untied
    untied = torch.randn(k, d, device=x.device, generator=torch.Generator(
        device=x.device).manual_seed(0)) * x.std()
    untied_ms = time_ms(lambda: trimmed.trimmed_mean_cuda(untied, b), reps=20)
    untied_library_ms = time_ms(lambda: torch.sort(untied, 0)[0][b:k - b].mean(0), reps=5,
                                warmup=1)
    emit({"phase": "drivers_cli_cifar10", "argv": list(DRIVERS_CLI_ARGV),
          "dataset": type(sim.dataset).__name__, "store_dtype": str(sim.dataset.train_x.dtype),
          "device": str(sim.device), "model_dim": sim.engine.dim,
          "client_opt": repr(sim.engine.client_opt), "numerics": during,
          "write_files_s": write_s, "wall_s": wall, "cold_round_s": sim.round_s[0],
          "warm_round_s": sim.round_s[1:], "round_spans_s": spans, "steps_s": steps_s,
          "step_ms": [t / DRIVERS_CLI_STEPS * 1e3 for t in steps_s],
          "peak_mem_bytes": peak, "launches": launches,
          "held": n_held, "max_abs_err": err, "elements_off_tol": bad,
          "train_loss": [r["Loss"] for r in train],
          "test": [{n: r[n] for n in ("Round", "Loss", "top1")} for r in test],
          "shape_kdb": [k, d, b], **timings,
          "share_of_bound": timings["bound_ms"] / timings["ms"],
          "untied_ms": untied_ms, "untied_library_ms": untied_library_ms, "card": card})
    check(sim.device.type == "cuda" and sim.engine.dim == DRIVERS_CLI_SHAPE[1],
          f"drivers_cli_cifar10: {sim.device}, D = {sim.engine.dim}")
    check((k, d, b) == DRIVERS_CLI_SHAPE, f"drivers_cli_cifar10: the kernel saw {(k, d, b)}")
    check(launches == DRIVERS_CLI_ROUNDS and n_held == launches and bad == 0,
          f"drivers_cli_cifar10: {launches} launches, {n_held} held, {bad} off {TOL}")
    check(len(train) == len(test) == len(spans) == DRIVERS_CLI_ROUNDS
          and all(math.isfinite(r["Loss"]) for r in train + test),
          f"drivers_cli_cifar10: records {train} {test} {spans}")
    check(during == {"cudnn_deterministic": True, "cudnn_benchmark": False,
                     "matmul_allow_tf32": False, "cudnn_allow_tf32": False},
          f"drivers_cli_cifar10: numerics {during}")
    return launches, err, timings


def phase_drivers_config1(torch, trimmed, card: str, log_root: Path) -> tuple:
    """``drivers_config1``: ``examples/convergence_config1.py``'s ``main``
    at its own settings but DRIVERS_CONFIG1_ROUNDS rounds (3 runs of 50
    local steps a round, the MLP at K=10, ALIE f=4), on its ``Synthetic``
    fallback (no MNIST files): each run's wall and launches (the
    trimmed-mean run's, one a round, each held against the plain version).
    Returns the launches and the largest error."""
    from blades_tpu_torch.examples import convergence_config1 as c1

    base = log_root / "drivers_config1"
    base.mkdir(parents=True)
    runs, run_one = [], c1.run_one

    def timed_run_one(agg, *a, **kw):
        trimmed.trimmed_mean_launches = 0
        t0 = time.perf_counter()
        out = run_one(agg, *a, **kw)
        torch.cuda.synchronize()
        runs.append({"aggregator": agg, "attack": kw.get("attack"),
                     "wall_s": time.perf_counter() - t0,
                     "launches": trimmed.trimmed_mean_launches, "dataset": out[1]})
        return out

    c1.run_one = timed_run_one
    try:
        with _Numerics(), _HeldKernel(torch, trimmed) as held:
            t0 = time.perf_counter()
            summary = c1.main(["--data-root", str(base / "no_data"), "--out", str(base / "out"),
                               "--rounds", str(DRIVERS_CONFIG1_ROUNDS)])
            wall = time.perf_counter() - t0
    finally:
        c1.run_one = run_one
    n_held, err, bad = held.result()
    launches = sum(r["launches"] for r in runs)
    emit({"phase": "drivers_config1", "wall_s": wall, "runs": runs,
          "final_top1": summary["final_top1"], "final_loss": summary["final_loss"],
          "dataset": summary["dataset"], "launches": launches, "held": n_held,
          "max_abs_err": err, "elements_off_tol": bad, "card": card})
    check([r["launches"] for r in runs] == [0, 0, DRIVERS_CONFIG1_ROUNDS]
          and n_held == launches and bad == 0,
          f"drivers_config1: launches {runs}, {n_held} held, {bad} off {TOL}")
    check(all(math.isfinite(v) for v in summary["final_loss"].values()),
          f"drivers_config1: {summary['final_loss']}")
    return launches, err


def _matrix_expectations(mod, matrix: dict) -> list:
    """The robustness matrix's expectations of the cells ``matrix`` holds
    (a ``band_rel`` rule needs its column's ``none`` cell too)."""
    rows, _ = mod.evaluate_expectations(matrix)
    return [r for r in rows if r["agg"] in matrix.get(r["attack"], {})]


#: what each example's record keeps of its ``main``'s return value
_DRIVERS_RECORD = {
    "simulation_on_mnist": lambda r: {"final_top1": r["final_top1"]},
    "customize_aggregator": lambda r: {"top1": r},
    "customize_attack": lambda r: {"rounds": DRIVERS_ATTACK_ROUNDS,
                                   "num_byzantine": r.num_byzantine},
    "fltrust_example": lambda r: {"top1": r},
    "fault_injection": lambda r: r,
    "streaming_clients": lambda r: {m: {"gauges": v["gauges"], "memory_records": v["memory"]}
                                    for m, v in r.items()},
    "async_fedbuff": lambda r: r,
    "metrics_trace": lambda r: {n: r[n] for n in ("identical_under_block", "byz_away",
                                                  "rounds")},
}


def phase_drivers_examples(torch, trimmed, card: str, log_root: Path) -> dict:
    """``drivers_examples``: every other example of the slice once through
    its ``main``, at its own settings (the robustness matrix on the
    DRIVERS_MATRIX_AGGS column), in a directory of its own: its wall, its
    launches (each held against the plain version) and whether its own
    assertions held; the matrix's expectations on its column and
    FLTrust's margin (20 rounds) are checked here. Returns the launches by
    example and the largest error."""
    import contextlib
    import importlib
    import os

    from blades_tpu_torch.examples import customize_attack

    out, errs = {}, []
    env = {n: os.environ.get(n) for n in ("CA_OUT", "FT_OUT")}
    attack_rounds = customize_attack.ROUNDS
    customize_attack.ROUNDS = DRIVERS_ATTACK_ROUNDS
    try:
        for name, argv in DRIVERS_EXAMPLES:
            base = log_root / "drivers_examples" / name
            base.mkdir(parents=True)
            os.environ.update(CA_OUT=str(base / "outputs"), FT_OUT=str(base / "outputs"))
            mod = importlib.import_module(f"blades_tpu_torch.examples.{name}")
            args = list(argv)  # relative paths: under ``base``, the working directory
            trimmed.trimmed_mean_launches = 0
            failure = None
            with _Numerics(), contextlib.chdir(base), _HeldKernel(torch, trimmed) as held:
                t0 = time.perf_counter()
                try:
                    result = mod.main(args)
                except AssertionError as e:  # the example's own assertion
                    result, failure = None, f"AssertionError: {e}"
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n_held, err, bad = held.result()
            errs.append(err)
            rec = {"wall_s": wall, "launches": trimmed.trimmed_mean_launches, "held": n_held,
                   "elements_off_tol": bad, "assertions_held": failure is None,
                   "failure": failure}
            if name == "robustness_matrix":
                rec["expectations"] = _matrix_expectations(mod, result)
                rec["assertions_held"] &= all(c["ok"] for c in rec["expectations"])
            elif result is not None:
                rec.update(_DRIVERS_RECORD[name](result))
            out[name] = rec
            emit({"phase": "drivers_examples", "example": name, "argv": args, **rec,
                  "max_abs_err": err, "card": card})
    finally:
        customize_attack.ROUNDS = attack_rounds
        for n, v in env.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
    bad = {n: r for n, r in out.items() if not r["assertions_held"] or r["elements_off_tol"]
           or r["held"] != r["launches"]}
    check(not bad, f"drivers_examples: {bad}")
    on = {n: out[n]["launches"] for n in DRIVERS_ON_KERNEL}
    off = {n: r["launches"] for n, r in out.items() if n not in DRIVERS_ON_KERNEL}
    check(all(on.values()) and not any(off.values()),
          f"drivers_examples: launches on the kernel's paths {on}, elsewhere {off}")
    check(out["metrics_trace"]["identical_under_block"], "drivers_examples: metrics_trace")
    return {"launches": on, "off_kernel": off, "err": max(errs)}


def drivers_phases(torch, trimmed, dev, card: str, log_root: Path) -> dict:
    """The slice 15a phases: the CLI's CCT-2 run, config 1, the other
    examples. Returns the launches by path (each above 0), those of the
    examples off the kernel (each 0), the largest error and the kernel's
    timings at the CLI's shape."""
    launches = {}
    launches["drivers_cli_cifar10"], cli_err, timings = phase_drivers_cli(
        torch, trimmed, dev, card, log_root)
    launches["drivers_config1"], c1_err = phase_drivers_config1(torch, trimmed, card,
                                                                log_root)
    ex = phase_drivers_examples(torch, trimmed, card, log_root)
    launches.update({f"drivers_{n}": v for n, v in ex["launches"].items()})
    return {"launches": launches, "off_kernel": ex["off_kernel"],
            "err": max(cli_err, c1_err, ex["err"]), "timings": timings}


# -- the static linter and the round-program auditor (slice 14) ----------------------

#: rounds of each of the CCT-2 audit's two graph blocks (the first warms up,
#: captures and replays; the second only replays)
ANALYSIS_BLOCK_ROUNDS = 2
#: each Tier-B program's launches in its two calls and the sharding check's
#: call on the virtual (2, 4) mesh: the eager round's one a round (4 column
#: blocks on the mesh); the block's warm-up and replays (2 blocks of 2
#: rounds, then 2 rounds of 4 on the mesh); map mode's 2 experiments a call
#: through one graph (4 launches each on the mesh); vmap mode's one batched
#: launch a call (the batched aggregate runs whole on the mesh); the
#: streaming and general async rounds take the masked form
ANALYSIS_TIER_B_LAUNCHES = {"round": (6, 0), "block": (12, 0), "streaming": (0, 0),
                            "experiment_batch_map": (12, 0), "experiment_batch_vmap": (0, 3),
                            "async": (0, 0)}
ANALYSIS_GRAPH_PROGRAMS = ("block", "experiment_batch_map", "experiment_batch_vmap")


class _HeldGraphKernel(_HeldKernel):
    """:class:`_HeldKernel` over both kernel entries and across CUDA graphs:
    a launch made while a graph captures (which runs nothing) keeps its
    input and output, buffers of the graph's own pool, and is held against
    the plain version after each replay of that graph, on the values the
    replay left in them; the others are held at once. Every launch is held
    once, so the held count equals the wrappers' count."""

    def __init__(self, torch, trimmed, keep_first: bool = False):
        from blades_tpu_torch.core import graphs

        super().__init__(torch, trimmed, keep_first)
        self.graphs = graphs
        self.orig_batched = trimmed.trimmed_mean_batched_cuda
        self.orig_capture = graphs.RoundGraph._capture
        self.orig_replay = torch.cuda.CUDAGraph.replay
        self.capturing = None  # the launches of the capture under way
        self.by_graph = {}  # id(CUDAGraph) -> (the graph, its launches)

    def _launch(self, orig, plain, x, b):
        out = orig(x, b)
        if self.torch.cuda.is_current_stream_capturing():
            self.capturing.append((plain, x, b, out))
            return out
        if self.keep_first and self.first is None and plain is self.trimmed.trimmed_mean_plain:
            self.first = (x.clone(), b)
        self._hold(out, plain(x, b))
        return out

    def __call__(self, x, b):
        return self._launch(self.orig, self.trimmed.trimmed_mean_plain, x, b)

    def batched(self, x, b):
        return self._launch(self.orig_batched, self.trimmed.trimmed_mean_batched_plain, x, b)

    def __enter__(self):
        held = self

        def capture(graph, eng):
            held.capturing = []
            try:
                held.orig_capture(graph, eng)
                held.by_graph[id(graph.graph)] = (graph.graph, held.capturing)
            finally:
                held.capturing = None

        def replay(cuda_graph):
            held.orig_replay(cuda_graph)
            for plain, x, b, out in held.by_graph.get(id(cuda_graph), (None, ()))[1]:
                held._hold(out, plain(x, b))

        self.trimmed.trimmed_mean_cuda = self
        self.trimmed.trimmed_mean_batched_cuda = self.batched
        self.graphs.RoundGraph._capture = capture
        self.torch.cuda.CUDAGraph.replay = replay
        return self

    def __exit__(self, *exc):
        self.trimmed.trimmed_mean_cuda = self.orig
        self.trimmed.trimmed_mean_batched_cuda = self.orig_batched
        self.graphs.RoundGraph._capture = self.orig_capture
        self.torch.cuda.CUDAGraph.replay = self.orig_replay
        self.by_graph.clear()  # the graphs and their buffers go with their engines
        return False


def start_analysis_tier_a():
    """``python -m blades_tpu_torch.analysis --check --tier a`` in a
    subprocess of its own, which says on stderr whether torch was loaded;
    returns the process and its start time."""
    code = ("import runpy, sys\n"
            "sys.argv = ['analysis', '--check', '--tier', 'a']\n"
            "try:\n"
            "    runpy.run_module('blades_tpu_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print('ANALYSIS_EXIT', e.code, 'ANALYSIS_TORCH', 'torch' in sys.modules,\n"
            "          file=sys.stderr)\n")
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, time.perf_counter()


def finish_analysis_tier_a(handle, card: str) -> float:
    """Wait for :func:`start_analysis_tier_a`'s run, emit its line; its
    seconds."""
    proc, t0 = handle
    out, err = proc.communicate(timeout=300)
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    tail = re.search(r"ANALYSIS_EXIT (\S+) ANALYSIS_TORCH (\S+)", err)
    line = json.loads(lines[-1]) if lines else None
    emit({"phase": "analysis_tier_a", "seconds": seconds, "returncode": proc.returncode,
          "stdout_lines": len(lines), "line": line,
          "torch_loaded": None if tail is None else tail.group(2) == "True",
          "waivers": [w for w in err.splitlines() if w.startswith("waived")], "card": card})
    check(proc.returncode == 0 and len(lines) == 1 and line["ok"] is True,
          f"analysis_tier_a: rc {proc.returncode}, {len(lines)} lines: {out[-500:]}{err[-2000:]}")
    check(tail is not None and tail.group(2) == "False",
          f"analysis_tier_a: torch loaded by --tier a ({err[-500:]})")
    return seconds


def phase_analysis_tier_b(torch, trimmed, card: str) -> dict:
    """``run_tier_b(device="cuda")``, one program at a time: every check's
    result, the graph captures and the launches (single and batched) per
    program, each launch held. Returns the launches, the batched launches,
    the largest error and the seconds."""
    from blades_tpu_torch.analysis.program_audit import PROGRAMS, run_tier_b
    from blades_tpu_torch.telemetry.recorder import process_counters

    t0 = time.perf_counter()
    per, checks = {}, []
    with _HeldGraphKernel(torch, trimmed) as held:
        trimmed.trimmed_mean_launches = trimmed.trimmed_mean_batched_launches = 0
        for program in PROGRAMS:
            c0 = process_counters().get("cuda.graph_captures", 0)
            l0, b0 = trimmed.trimmed_mean_launches, trimmed.trimmed_mean_batched_launches
            p0 = time.perf_counter()
            report = run_tier_b("cuda", programs=[program])
            torch.cuda.synchronize()
            batched = trimmed.trimmed_mean_batched_launches - b0
            per[program] = {"ok": report["ok"], "seconds": time.perf_counter() - p0,
                            "graph_captures": process_counters().get(
                                "cuda.graph_captures", 0) - c0,
                            "launches": trimmed.trimmed_mean_launches - l0 - batched,
                            "batched_launches": batched}
            checks += report["checks"]
        launches = trimmed.trimmed_mean_launches
        batched = trimmed.trimmed_mean_batched_launches
        n_held, err, bad = held.result()
    seconds = time.perf_counter() - t0
    emit({"phase": "analysis_tier_b", "checks": checks, "by_program": per,
          "launches": launches - batched, "batched_launches": batched, "held": n_held,
          "max_abs_err": err, "elements_off_tol": bad, "seconds": seconds, "card": card})
    failed = [f"{c['program']}/{c['check']}: {c['detail']}" for c in checks if c["ok"] is False]
    check(not failed, f"analysis_tier_b: {failed}")
    check(all(c["ok"] is not None for c in checks), "analysis_tier_b: a check was skipped")
    for program, (single, batch) in ANALYSIS_TIER_B_LAUNCHES.items():
        got = per[program]
        check((got["launches"], got["batched_launches"]) == (single, batch),
              f"analysis_tier_b {program}: launches {got}")
        # one graph for the audit's engine, one for the sharding check's
        check(got["graph_captures"] == 2 * (program in ANALYSIS_GRAPH_PROGRAMS),
              f"analysis_tier_b {program}: {got['graph_captures']} graph captures")
    check(n_held == launches and bad == 0,
          f"analysis_tier_b: {n_held} of {launches} launches held, {bad} elements off")
    return {"launches": launches - batched, "batched": batched, "err": err,
            "seconds": seconds}


def phase_analysis_cct2(torch, trimmed, fl, card: str, log_root: Path,
                        keep_first: bool = False) -> dict:
    """The auditor's four checks on the main path: bf16 CCT-2 at K=1000 in
    CCT2_CHUNKS chunks, ALIE f=5, trimmed mean b=5, on the store ``fl``;
    one eager round run twice, then one graph block of
    ANALYSIS_BLOCK_ROUNDS rounds run twice, the engine looked up in an
    ``EngineCache`` before each call, and each program once more on the
    same engine built with a plan over the auditor's virtual (2, 4) mesh of
    the card (the sharding check: its rows and new params against the first
    call's). Returns the launches, the largest error, the seconds and
    (``keep_first``) the first launch's input."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.analysis.program_audit import (
        _MESH_SHAPE,
        audit_program,
        block_call,
        round_call,
    )
    from blades_tpu_torch.core import RoundEngine
    from blades_tpu_torch.parallel import make_mesh, make_plan
    from blades_tpu_torch.sweeps import EngineCache
    from blades_tpu_torch.telemetry.recorder import process_counters
    from blades_tpu_torch.utils import rng

    t0 = time.perf_counter()
    k, _, b = CCT2_SHAPE
    gc.collect()
    torch.cuda.empty_cache()
    sim = Simulator(dataset=fl, attack="alie", num_byzantine=b, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": b}, seed=1,
                    log_path=str(log_root / "analysis_cct2"))
    sim.run(model="cct_2_3x2_32", global_rounds=0, client_chunks=CCT2_CHUNKS,
            compute_dtype="bfloat16")
    eng, seed = sim.engine, sim.seed
    eng.keep_updates = True  # the sharding check compares the round's rows
    p0 = {n: t.clone() for n, t in sim.server.state.params.items()}
    spec = sim._model_spec("cct_2_3x2_32", "crossentropy", "bfloat16")
    plan = make_plan(make_mesh([eng.device] * math.prod(_MESH_SHAPE), _MESH_SHAPE))

    def sharded():
        return RoundEngine(spec.train_loss_fn, spec.eval_logits_fn, p0, spec.layout,
                           num_clients=k, num_byzantine=b, attack=eng.attack,
                           aggregator=eng.aggregator, num_classes=eng.num_classes,
                           client_chunks=CCT2_CHUNKS, noise_sites=spec.noise_sites,
                           plan=plan)

    del sim
    cache = EngineCache()
    cache.put("cct2_bf16_k1000", eng)
    def batch():
        # round 1's draw each call: fresh tensors of the same batch, so that
        # the sharding check's call takes the first call's inputs
        gen = rng.generator(seed, 1, rng.DATA, device=eng.device)
        return list(fl.sample_round(gen, 1, 32))

    build_s = time.perf_counter() - t0
    rec = {}
    with _HeldGraphKernel(torch, trimmed, keep_first=keep_first) as held:
        trimmed.trimmed_mean_launches = 0
        checks = []
        for program, call in (
                ("cct2_round", round_call(seed, batch)),
                ("cct2_block", block_call(fl.sampler(1, 32), ANALYSIS_BLOCK_ROUNDS, seed))):
            c0 = process_counters().get("cuda.graph_captures", 0)
            l0 = trimmed.trimmed_mean_launches
            p1 = time.perf_counter()
            checks += audit_program(program, lambda: cache.get("cct2_bf16_k1000"),
                                    eng.init(p0), call, cache, sharded)
            torch.cuda.synchronize()
            rec[program] = {"seconds": time.perf_counter() - p1,
                            "graph_captures": process_counters().get(
                                "cuda.graph_captures", 0) - c0,
                            "launches": trimmed.trimmed_mean_launches - l0,
                            "mode": eng.last_block_mode if program == "cct2_block" else "eager"}
        launches = trimmed.trimmed_mean_launches
        n_held, err, bad = held.result()
        first = held.first
    graph = eng.last_graph
    peak = torch.cuda.max_memory_allocated()
    del eng, graph, cache
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    emit({"phase": "analysis_cct2", "model": "cct_2_3x2_32", "dtype": "bfloat16",
          "clients": k, "client_chunks": CCT2_CHUNKS, "attack": "alie",
          "aggregator": "trimmedmean", "block_rounds": ANALYSIS_BLOCK_ROUNDS,
          "checks": checks, "by_program": rec, "launches": launches, "held": n_held,
          "max_abs_err": err, "elements_off_tol": bad, "engine_build_s": build_s,
          "seconds": seconds, "peak_mem_bytes": peak, "card": card})
    failed = [f"{c['program']}/{c['check']}: {c['detail']}" for c in checks if c["ok"] is False]
    check(not failed, f"analysis_cct2: {failed}")
    check(rec["cct2_block"]["mode"] == "graph", f"analysis_cct2: the block ran {rec}")
    # the sharded engine's program: a graph of its own for the block; 4
    # column blocks a round
    check(rec["cct2_round"]["graph_captures"] == 0 and rec["cct2_block"]["graph_captures"] == 2,
          f"analysis_cct2: graph captures {rec}")
    check(rec["cct2_round"]["launches"] == 2 + 4
          and rec["cct2_block"]["launches"] == (2 + 4) * ANALYSIS_BLOCK_ROUNDS,
          f"analysis_cct2: launches {rec}")
    check(n_held == launches and bad == 0,
          f"analysis_cct2: {n_held} of {launches} launches held, {bad} elements off")
    return {"launches": launches, "err": err, "seconds": seconds, "first": first}


def analysis_phases(torch, trimmed, card: str, log_root: Path,
                    keep_first: bool = False, fl=None) -> dict:
    """The slice 14 phases: Tier A in a subprocess beside Tier B on the
    card, then the CCT-2 audit on the CIFAR-shaped store ``fl`` (built here
    when None). Returns the launches by path, the batched launches, the
    largest error, the CCT-2 audit's first launch's input (``keep_first``)
    and the store."""
    t0 = time.perf_counter()
    tier_a = start_analysis_tier_a()
    tier_b = phase_analysis_tier_b(torch, trimmed, card)
    tier_a_s = finish_analysis_tier_a(tier_a, card)
    t1 = time.perf_counter()
    fl = cct2_simulator(torch, log_root).dataset if fl is None else fl
    store_s = time.perf_counter() - t1
    cct2 = phase_analysis_cct2(torch, trimmed, fl, card, log_root, keep_first)
    seconds = {"analysis_tier_a": tier_a_s, "analysis_tier_b": tier_b["seconds"],
               "analysis_cct2": cct2["seconds"], "store": store_s,
               "total": time.perf_counter() - t0}
    emit({"phase": "analysis", "seconds": seconds, "card": card})
    return {"launches": {"analysis_tier_b": tier_b["launches"],
                         "analysis_cct2": cct2["launches"]},
            "batched": {"analysis_tier_b_vmap": tier_b["batched"]},
            "err": max(tier_b["err"], cct2["err"]), "first": cct2["first"], "store": fl}


# -- the run-record readers, the last single-card examples and the LEAF tools (slice 15b) --

#: rounds of the telemetry example's recipe on the main path
TOOLS_TRACE_ROUNDS = 3
#: the slice's examples, in the order run, with their argv (their own
#: settings; each runs in a working directory of its own, so "out" is its)
TOOLS_EXAMPLES = (
    ("telemetry_trace", ("--out", "out")),
    ("run_ledger", ("--out", "out")),
    ("defense_audit", ("--out", "out")),
    ("plot_comparing_aggregation_schemes", ("--out", "out/aggregation_schemes.png")),
    ("fedavg_ipm", ("--out", "out")),
)
#: the launches of the examples whose runs reach the kernel: the telemetry
#: demo's defense once a round (2 rounds, [8, 59850], b=2), the aggregator
#: comparison's trimmed mean once ([100, 2], b=5); the others' defenses
#: are not the trimmed mean
TOOLS_ON_KERNEL = {"telemetry_trace": 2, "plot_comparing_aggregation_schemes": 1}
#: the certify driver's trimmed-mean cells, on the card: the sweep trace
#: and the ledger record that tools_readers reads
TOOLS_CERT_ARGS = ("--quick", "--no-async", "--aggs", "trimmedmean")
#: FEMNIST in LEAF's format: 784 floats and one of 62 classes a sample,
#: 10,000 samples over 100 users; the preprocess pipeline's flags
LEAF_USERS, LEAF_SAMPLES, LEAF_WIDTH, LEAF_CLASSES = 100, 10_000, 784, 62
LEAF_ARGS = ("-s", "niid", "--sf", "0.5", "-k", "10", "-t", "sample", "--tf", "0.9",
             "--smplseed", "1", "--spltseed", "2")


def write_leaf_femnist(root: Path, seed: int = 0) -> None:
    """A FEMNIST-shaped LEAF ``all_data`` directory (``LEAF_*``): users of
    uneven size (at least 20 samples), white background pixels (1.0) and
    strokes of k/255, 4 decimals, as LEAF's JSON holds them; two files."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counts = 20 + rng.multinomial(LEAF_SAMPLES - 20 * LEAF_USERS,
                                  rng.dirichlet(np.ones(LEAF_USERS)))
    root.mkdir(parents=True)
    users = [f"f_{i:04d}" for i in range(LEAF_USERS)]
    half = LEAF_USERS // 2
    for part, chunk in enumerate((range(half), range(half, LEAF_USERS))):
        data = {"users": [], "num_samples": [], "user_data": {}}
        for i in chunk:
            n = int(counts[i])
            x = np.where(rng.random((n, LEAF_WIDTH)) < 0.8, 1.0,
                         np.round(rng.integers(0, 255, (n, LEAF_WIDTH)) / 255, 4))
            data["users"].append(users[i])
            data["num_samples"].append(n)
            data["user_data"][users[i]] = {"x": x.tolist(),
                                           "y": rng.integers(0, LEAF_CLASSES, n).tolist()}
        with open(root / f"all_data_{part}.json", "w") as f:
            json.dump(data, f)


def leaf_child(out: str) -> int:
    """``--leaf-child OUT``: the LEAF tools on the host, no torch: write the
    FEMNIST-shaped directory, run the preprocess pipeline (``LEAF_ARGS``)
    through its ``main``, then ``--verify`` as a process of its own on the
    pipeline's output (must pass) and on a tampered copy of one stage file
    (must fail). One ``LEAF`` line gives the walls and the results."""
    import contextlib
    import io
    import os
    import shutil

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from blades_tpu_torch.leaf import preprocess

    base = Path(out)
    t0 = time.perf_counter()
    write_leaf_femnist(base / "all_data")
    write_s = time.perf_counter() - t0
    raw_bytes = sum(f.stat().st_size for f in (base / "all_data").iterdir())
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        preprocess.main(["--data-dir", str(base / "all_data"), "--out-dir", str(base / "out"),
                         *LEAF_ARGS])
    pipeline_s = time.perf_counter() - t0
    stats = json.loads(printed.getvalue()[printed.getvalue().index("{"):])
    manifest = base / "out" / "meta" / "manifest.json"
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)}

    def verify(out_dir: Path) -> dict:
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "blades_tpu_torch.leaf.preprocess",
                               "--out-dir", str(out_dir), "--verify", str(manifest)], env=env,
                              capture_output=True, text=True, timeout=300)
        return {"rc": proc.returncode, "wall_s": time.perf_counter() - t1,
                "last_line": (proc.stdout.strip().splitlines() or [""])[-1]}

    good = verify(base / "out")
    shutil.copytree(base / "out", base / "tampered")
    (base / "tampered" / "test" / "test.json").write_text('{"users": []}')
    tampered = verify(base / "tampered")
    print("LEAF " + json.dumps({
        "users": LEAF_USERS, "samples": LEAF_SAMPLES, "width": LEAF_WIDTH,
        "classes": LEAF_CLASSES, "args": list(LEAF_ARGS), "raw_bytes": raw_bytes,
        "write_s": write_s, "pipeline_s": pipeline_s, "final_stats": stats,
        "manifest_files": sorted(json.loads(manifest.read_text())), "verify": good,
        "verify_tampered": tampered, "torch_imported": "torch" in sys.modules}), flush=True)
    return 0


def start_leaf(log_root: Path):
    """``tools_leaf`` in a process of its own, beside the card's phases
    (killed at exit should a later phase fail before it is collected)."""
    import atexit
    import os

    out = log_root / "tools_leaf"
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--leaf-child", str(out)],
        cwd=str(Path(__file__).resolve().parent), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env={**os.environ, **BESIDE_ENV})
    atexit.register(proc.kill)
    return out, time.perf_counter(), proc


def finish_leaf(handle, card: str) -> float:
    """``tools_leaf``: the LEAF pipeline's record (host work only, no card):
    its walls, the final stats and the ``--verify`` results. Returns the
    child's wall."""
    out, t0, proc = handle
    text, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    lines = [json.loads(line[5:]) for line in text.splitlines() if line.startswith("LEAF ")]
    check(proc.returncode == 0 and len(lines) == 1, f"tools_leaf: rc {proc.returncode}\n"
          f"{text[-3000:]}")
    rec = lines[0]
    emit({"phase": "tools_leaf", "host_only": True, "child_wall_s": wall, **rec, "card": card})
    check(rec["verify"]["rc"] == 0 and "Matching" in rec["verify"]["last_line"]
          and rec["verify_tampered"]["rc"] == 1 and not rec["torch_imported"],
          f"tools_leaf: {rec}")
    check(rec["manifest_files"] == ["rem_user_data/pruned.json", "sampled_data/sampled.json",
                                    "test/test.json", "train/train.json"]
          and 0 < rec["final_stats"]["num_samples"] < LEAF_SAMPLES,
          f"tools_leaf: {rec['manifest_files']} {rec['final_stats']}")
    return wall


def phase_tools_trace_cct2(torch, trimmed, fl, card: str, log_root: Path,
                           keep_first: bool = False) -> dict:
    """``tools_trace_cct2``: the telemetry example's recipe on the main
    path (bf16 CCT-2 at K=1000 in CCT2_CHUNKS chunks, ALIE f=5 + trimmed
    mean b=5, 1 local step of batch 32, TOOLS_TRACE_ROUNDS rounds,
    ``collect_diagnostics=True``) on the store ``fl``, its trace read by the
    port's ``trace_summary --json``: the table on the lines before, then the
    round span's split (sample / dispatch / sync / eval), the first round
    apart from the warm ones, the dispatch share, the provenance, the
    byzantine share of the trimmed slots, the peak memory and the
    launches, each held. Returns the launches, the largest error, the
    trace and (``keep_first``) the first launch's input."""
    import contextlib
    import io

    from blades_tpu_torch import Simulator
    from blades_tpu_torch.examples import trace_summary

    k, _, b = CCT2_SHAPE
    gc.collect()
    torch.cuda.empty_cache()
    log_dir = log_root / "tools_trace_cct2"
    sim = Simulator(dataset=fl, attack="alie", num_byzantine=b, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": b}, seed=1, log_path=str(log_dir))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trimmed.trimmed_mean_launches = 0
    with _HeldKernel(torch, trimmed, keep_first=keep_first) as held:
        t0 = time.perf_counter()
        round_s = sim.run(model="cct_2_3x2_32", global_rounds=TOOLS_TRACE_ROUNDS, local_steps=1,
                          server_lr=1.0, client_lr=0.1, validate_interval=TOOLS_TRACE_ROUNDS,
                          client_chunks=CCT2_CHUNKS, compute_dtype="bfloat16",
                          collect_diagnostics=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = trimmed.trimmed_mean_launches
        n_held, err, bad = held.result()
    peak = torch.cuda.max_memory_allocated()
    del sim
    trace = log_dir / "telemetry.jsonl"
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = trace_summary.main([str(trace), "--json"])
    summary = json.loads(printed.getvalue())
    read_s = time.perf_counter() - t0
    print(trace_summary.format_table(summary), flush=True)
    spans = round_spans(trace)
    split = {n: {"first_s": spans[0].get(n, 0.0), "warm_s": [r.get(n, 0.0) for r in spans[1:]],
                 "total_s": sum(r.get(n, 0.0) for r in spans)}
             for n in ("round", "sample", "dispatch", "sync", "eval")}
    defense = [r for r in map(json.loads, trace.read_text().splitlines())
               if r.get("t") == "defense"]
    emit({"phase": "tools_trace_cct2", "model": "cct_2_3x2_32", "dtype": "bfloat16",
          "clients": k, "client_chunks": CCT2_CHUNKS, "attack": "alie", "b": b,
          "rounds": TOOLS_TRACE_ROUNDS, "round_s": round_s, "wall_s": wall, "split": split,
          "dispatch_share": summary["dispatch"].get("dispatch_share"),
          "dispatch": {n: summary["dispatch"].get(n) for n in ("launches", "enqueue_s",
                                                               "ready_s")},
          "provenance": {n: v for n, v in summary["provenance"].items()
                         if n != "by_fingerprint"},
          "mean_byz_trim_frac": summary["defense"].get("mean_byz_trim_frac"),
          "config_fingerprint": summary["run"].get("config_fingerprint"),
          "peak_mem_bytes": peak, "launches": launches, "held": n_held, "max_abs_err": err,
          "elements_off_tol": bad, "reader_s": read_s, "card": card})
    check(rc == 0 and summary["rounds"]["count"] == TOOLS_TRACE_ROUNDS == len(spans),
          f"tools_trace_cct2: reader rc {rc}, rounds {summary['rounds']}, spans {spans}")
    check(all(n in r for r in spans for n in ("sample", "dispatch", "sync"))
          and "eval" in spans[-1], f"tools_trace_cct2: spans {spans}")
    check(len(defense) == TOOLS_TRACE_ROUNDS
          and 0.0 <= summary["defense"]["mean_byz_trim_frac"] <= 1.0
          and all(sum(r["trim_counts"]) == 2 * b * CCT2_SHAPE[1] for r in defense),
          f"tools_trace_cct2: defense {summary['defense']}")
    check(launches == TOOLS_TRACE_ROUNDS and n_held == launches and bad == 0,
          f"tools_trace_cct2: {launches} launches, {n_held} held, {bad} off {TOL}")
    return {"launches": launches, "err": err, "trace": trace, "first": held.first}


#: what each example's record keeps of its ``main``'s return value
_TOOLS_RECORD = {
    "telemetry_trace": lambda r: {"mean_byz_trim_frac": r["defense"].get("mean_byz_trim_frac"),
                                  "rounds": r["rounds"]["count"]},
    "run_ledger": lambda r: {"alerts_diverging": [a["rule"] for a in r["alerts"]],
                             "alerts_healthy": r["healthy_alerts"],
                             "rerun_fingerprint": ("same" if r["same_config_same_fingerprint"]
                                                   else "different"),
                             "diverging_fingerprint": ("different" if r["diverging_differs"]
                                                       else "same"),
                             "stamped": r["stamped"]},
    "defense_audit": lambda r: {"verdicts": {n: c["verdict"] for n, c in r["cells"].items()},
                                "worst_ratio": {n: c["worst_ratio"]
                                                for n, c in r["cells"].items()},
                                "breached_rounds": sum(a["breach"] for a in r["audits"]),
                                "fallback_rounds": sum(a["fallback_used"] for a in r["audits"]),
                                "bit_reproducible": r["bit_reproducible"],
                                "final_eval": r["final_eval"]},
    "plot_comparing_aggregation_schemes": lambda r: {"tags": {n: v["tag"]
                                                              for n, v in r.items()}},
    "fedavg_ipm": lambda r: {"final_top1": r["summary"]["final_top1"],
                             "d2_d4_agreement": r["d2_d4_agreement"],
                             "rounds_checked": r["verdict"]["rounds_checked"],
                             "krum_selected_byzantine_frac":
                                 r["verdict"]["fraction_rounds_krum_selected_byzantine"],
                             "initial_capture_streak":
                                 r["verdict"]["initial_byzantine_capture_streak"],
                             "reference": (None if not r["verdict"]["reference_available"]
                                           else r["verdict"]["selection_agreement_with_reference"]),
                             "dataset": r["dataset"]},
}


def phase_tools_examples(torch, trimmed, card: str, log_root: Path) -> dict:
    """``tools_examples``: the slice's examples once each through ``main``
    at their own settings, in a directory of their own: the wall, the
    launches (each held against the plain version), whether the example's
    own assertions held, and what each claims (the four verdicts; the
    alerts and fingerprints; the tags; both arms' top-1, the d^2/d^4
    agreement and the captured rounds). Returns the launches by example,
    the largest error, and the first launch's input on each kernel path."""
    import contextlib
    import importlib
    import os

    out, errs, firsts = {}, [], {}
    saved_ledger = os.environ.get("BLADES_LEDGER")
    try:
        for name, argv in TOOLS_EXAMPLES:
            base = log_root / "tools_examples" / name
            base.mkdir(parents=True)
            mod = importlib.import_module(f"blades_tpu_torch.examples.{name}")
            trimmed.trimmed_mean_launches = 0
            failure = None
            with _Numerics(), contextlib.chdir(base), \
                    _HeldKernel(torch, trimmed, keep_first=True) as held:
                t0 = time.perf_counter()
                try:
                    result = mod.main(list(argv))
                except AssertionError as e:  # the example's own assertion
                    result, failure = None, f"AssertionError: {e}"
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            n_held, err, bad = held.result()
            errs.append(err)
            if held.first is not None:
                firsts[name] = held.first
            rec = {"wall_s": wall, "launches": trimmed.trimmed_mean_launches, "held": n_held,
                   "elements_off_tol": bad, "assertions_held": failure is None,
                   "failure": failure}
            if result is not None:
                rec.update(_TOOLS_RECORD[name](result))
            out[name] = rec
            emit({"phase": "tools_examples", "example": name, "argv": list(argv), **rec,
                  "max_abs_err": err, "card": card})
            # run_ledger points BLADES_LEDGER at its demo ledger
            os.environ["BLADES_LEDGER"] = saved_ledger
    finally:
        os.environ["BLADES_LEDGER"] = saved_ledger
    bad = {n: r for n, r in out.items() if not r["assertions_held"] or r["elements_off_tol"]
           or r["held"] != r["launches"] or r["launches"] != TOOLS_ON_KERNEL.get(n, 0)}
    check(not bad, f"tools_examples: {bad}")
    audit = out["defense_audit"]
    check(audit["verdicts"] == {"mean": "BREAKS", "median": "CERTIFIED", "krum": "CERTIFIED",
                                "centeredclipping": "CERTIFIED"} and audit["bit_reproducible"]
          and audit["breached_rounds"] == audit["fallback_rounds"] > 0,
          f"tools_examples: defense_audit {audit}")
    ledger_demo = out["run_ledger"]
    # throughput_drop reads the wall clock (a round 3x the run's median, the
    # final round's validation among them): it may join loss_divergence
    check("loss_divergence" in ledger_demo["alerts_diverging"]
          and set(ledger_demo["alerts_diverging"]) <= {"loss_divergence", "throughput_drop"}
          and ledger_demo["alerts_healthy"] == 0 and ledger_demo["rerun_fingerprint"] == "same"
          and ledger_demo["diverging_fingerprint"] == "different" and ledger_demo["stamped"],
          f"tools_examples: run_ledger {ledger_demo}")
    ipm = out["fedavg_ipm"]
    check(ipm["rounds_checked"] == 30 and ipm["reference"] is None
          and all(0.0 <= v <= 1.0 for v in ipm["final_top1"].values()),
          f"tools_examples: fedavg_ipm {ipm}")
    check(len(out["plot_comparing_aggregation_schemes"]["tags"]) == 14,
          f"tools_examples: plot {out['plot_comparing_aggregation_schemes']}")
    return {"launches": {n: out[n]["launches"] for n in TOOLS_ON_KERNEL},
            "off_kernel": {n: r["launches"] for n, r in out.items() if n not in TOOLS_ON_KERNEL},
            "err": max(errs), "firsts": firsts}


def _reader(argv: list) -> dict:
    """One reader of the port run as a process of its own: its exit code,
    wall and the one JSON line it printed."""
    import os

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=str(root), capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(root)})
    lines = proc.stdout.strip().splitlines()
    try:
        payload = json.loads(lines[0]) if len(lines) == 1 else None
    except json.JSONDecodeError:
        payload = None
    return {"rc": proc.returncode, "wall_s": time.perf_counter() - t0, "lines": len(lines),
            "payload": payload, "stderr": proc.stderr[-500:]}


def phase_tools_readers(torch, trimmed, card: str, log_root: Path, trace: Path) -> tuple:
    """``tools_readers``: the certify driver's trimmed-mean cells on the
    card (TOOLS_CERT_ARGS; each launch held), then the port's ``runs``
    (the whole ledger, and ``--run-id`` of that certify run),
    ``sweep_status`` (its sweep trace and every service trace of this
    script's run) and ``trace_summary`` (``--json`` and ``--compare``
    on ``tools_trace_cct2``'s trace), each a process of its own: each
    exits 0 with one JSON line. Returns the certify run's launches and the
    largest error."""
    import os

    from blades_tpu_torch.examples import certify
    from blades_tpu_torch.telemetry.ledger import read_ledger

    cert_out = log_root / "tools_readers" / "certify"
    trimmed.trimmed_mean_launches = 0
    with _HeldKernel(torch, trimmed) as held:
        t0 = time.perf_counter()
        cert_rc = certify.main([*TOOLS_CERT_ARGS, "--out", str(cert_out)])
        torch.cuda.synchronize()
        cert_s = time.perf_counter() - t0
        launches = trimmed.trimmed_mean_launches
        n_held, err, bad = held.result()
    ledger_path = os.environ["BLADES_LEDGER"]
    run_id = [r for r in read_ledger(ledger_path)
              if r.get("kind") == "certify" and r.get("event") == "started"][-1]["run_id"]
    calls = {
        "runs": ["blades_tpu_torch.examples.runs", "--ledger", ledger_path],
        "runs_run_id": ["blades_tpu_torch.examples.runs", "--ledger", ledger_path,
                        "--run-id", run_id],
        "sweep_status": ["blades_tpu_torch.examples.sweep_status", str(cert_out)],
        "trace_summary": ["blades_tpu_torch.examples.trace_summary", "--json", str(trace)],
        "trace_summary_compare": ["blades_tpu_torch.examples.trace_summary", "--compare",
                                  str(trace), str(trace), "--json"],
    }
    for i, svc in enumerate(sorted(log_root.rglob("service_trace.jsonl"))):
        calls[f"sweep_status_service_{i}"] = ["blades_tpu_torch.examples.sweep_status", str(svc)]
    got = {name: _reader(argv) for name, argv in calls.items()}
    runs, by_id, status = got["runs"]["payload"], got["runs_run_id"]["payload"], got[
        "sweep_status"]["payload"]
    emit({"phase": "tools_readers", "certify_rc": cert_rc, "certify_s": cert_s,
          "launches": launches, "held": n_held, "max_abs_err": err, "elements_off_tol": bad,
          "readers": {n: {"rc": r["rc"], "wall_s": r["wall_s"], "lines": r["lines"]}
                      for n, r in got.items()},
          "ledger_runs": runs and runs.get("runs"), "by_kind": runs and runs.get("by_kind"),
          "by_outcome": runs and runs.get("by_outcome"),
          "sweep_progress": by_id and by_id.get("sweep_progress"),
          "sweep_families": status and status.get("sweeps"),
          "service_traces": sum(n.startswith("sweep_status_service") for n in got),
          "card": card})
    failed = {n: r for n, r in got.items() if r["rc"] != 0 or r["payload"] is None}
    check(cert_rc == 0 and not failed, f"tools_readers: certify rc {cert_rc}, {failed}")
    check(runs["ok"] and runs["runs"] > 0 and by_id["found"]
          and by_id["sweep_progress"]["cells_completed"] == by_id["sweep_progress"]["total"]
          and status["ok"], f"tools_readers: {runs} {by_id} {status}")
    summary = got["trace_summary"]["payload"]
    check(summary["rounds"]["count"] == TOOLS_TRACE_ROUNDS
          and got["trace_summary_compare"]["payload"]["a"] == summary,
          "tools_readers: the trace's summary")
    check(launches > 0 and n_held == launches and bad == 0,
          f"tools_readers: {launches} launches, {n_held} held, {bad} off {TOL}")
    return launches, err


def tools_phases(torch, trimmed, card: str, log_root: Path, fl=None,
                 keep_first: bool = False, leaf=None, trace=None, settle=None) -> dict:
    """The slice 15b phases: the LEAF pipeline in a process of its own
    beside the others (host work only; started here unless ``leaf`` is the
    handle of one started before), the CCT-2 trace on the store ``fl``
    (built here when None; ``trace``: the result of a
    :func:`phase_tools_trace_cct2` call made before), the examples, then
    the readers; ``settle`` is called before the kernel's timings (to have
    the card to this process alone). Returns the launches by path, those of
    the examples off the kernel (each 0), the largest error and the
    kernel's timings at the examples' shapes (and at the trace's,
    ``keep_first``)."""
    t0 = time.perf_counter()
    leaf = leaf or start_leaf(log_root)
    store_s = 0.0
    if trace is None:
        if fl is None:
            t1 = time.perf_counter()
            fl = cct2_simulator(torch, log_root).dataset
            store_s = time.perf_counter() - t1
        trace = phase_tools_trace_cct2(torch, trimmed, fl, card, log_root, keep_first)
    del fl
    t1 = time.perf_counter()
    examples = phase_tools_examples(torch, trimmed, card, log_root)
    examples_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    launches = {"tools_trace_cct2": trace["launches"],
                **{f"tools_{n}": v for n, v in examples["launches"].items()}}
    launches["tools_readers_certify"], readers_err = phase_tools_readers(
        torch, trimmed, card, log_root, trace["trace"])
    readers_s = time.perf_counter() - t1
    leaf_s = finish_leaf(leaf, card)
    if settle is not None:
        settle()
    shapes = {}
    for name, (x, b) in examples["firsts"].items():
        shapes[(*x.shape, b)] = kernel_timings(torch, trimmed, x, b)
    if trace["first"] is not None:
        x, b = trace["first"]
        shapes[(*x.shape, b)] = kernel_timings(torch, trimmed, x, b, reps=3)
        del x
    trace["first"] = None
    emit({"phase": "tools", "seconds": {"store": store_s, "examples": examples_s,
                                        "readers": readers_s, "leaf_child": leaf_s,
                                        "total": time.perf_counter() - t0},
          "by_shape": [{"shape_kdb": list(s), **t} for s, t in shapes.items()], "card": card})
    return {"launches": launches, "off_kernel": examples["off_kernel"],
            "err": max(trace["err"], examples["err"], readers_err), "shapes": shapes}


# -- the parallel layer (slice 12) ------------------------------------------------

#: the main path on a virtual (clients, model) mesh of the card
PARALLEL_MESH_SHAPE = (2, 2)
PARALLEL_ROUNDS = 2
#: the long-context example's configuration on a virtual seq mesh
PARALLEL_SEQ, PARALLEL_SEQ_BATCH, PARALLEL_SEQ_DEVICES = 8192, 2, 8
PARALLEL_LOGIT_BAR = 3e-4  # the JAX example's bar
PARALLEL_GRAD_REL_L2 = 1e-4  # per leaf, as the CPU tests' gradient bar
#: the multi-process worker's virtual entries of cuda:0: K = 16, b = 4
PARALLEL_DIST_DEVICES = 8
#: the pod example's rounds, and its clients: 256 of its 1024 (a fresh
#: process's first CCT-2 round is most of its wall at any K)
PARALLEL_POD_ROUNDS, PARALLEL_POD_CLIENTS = 2, 256


class _HeldShapes(_HeldKernel):
    """:class:`_HeldKernel` that also keeps each launch's input shape."""

    def __init__(self, torch, trimmed, keep_first: bool = False):
        super().__init__(torch, trimmed, keep_first)
        self.shapes = []

    def __call__(self, x, b):
        self.shapes.append(tuple(x.shape))
        return super().__call__(x, b)


def parallel_cct2_run(torch, trimmed, fl, log_root: Path, name: str, keep_first: bool,
                      **sim_kw) -> dict:
    """PARALLEL_ROUNDS bf16 CCT-2 rounds of the main path on the store
    ``fl`` through ``Simulator.run``: each round's wall, the aggregate the
    server applied (read at ``RoundEngine._server_step``), the new params,
    the launches (counted, and held with their shapes) and the peak
    memory."""
    from blades_tpu_torch import Simulator
    from blades_tpu_torch.core.engine import RoundEngine

    k, _, b = CCT2_SHAPE
    aggs, orig = [], RoundEngine._server_step

    def spy(self, params, opt_state, lr, agg):
        aggs.append(agg.detach().clone())
        return orig(self, params, opt_state, lr, agg)

    sim = Simulator(fl, attack="alie", num_byzantine=b, aggregator="trimmedmean",
                    aggregator_kws={"num_byzantine": b}, seed=1,
                    log_path=str(log_root / name), **sim_kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    RoundEngine._server_step = spy
    try:
        with _HeldShapes(torch, trimmed, keep_first) as held:
            trimmed.trimmed_mean_launches = 0
            times = sim.run(model="cct_2_3x2_32", global_rounds=PARALLEL_ROUNDS, local_steps=1,
                            train_batch_size=32, client_chunks=CCT2_CHUNKS,
                            compute_dtype="bfloat16",
                            # no evaluation: every round is a round alone
                            validate_interval=PARALLEL_ROUNDS + 1)
            torch.cuda.synchronize()
            launches = trimmed.trimmed_mean_launches
    finally:
        RoundEngine._server_step = orig
    n_held, err, bad = held.result()
    x = sim.dataset.train_x
    rows = ([[a, b, str(t.device)] for t, a, b in zip(x.pieces, x.starts, x.starts[1:])]
            if sim.dataset.placed else None)
    return {"times": times, "launches": launches, "held": n_held, "err": err, "bad": bad,
            "placed": sim.dataset.placed, "store_rows": rows,
            "shapes": held.shapes, "first": held.first, "aggs": aggs,
            "params": {n: t.detach().clone() for n, t in sim.server.state.params.items()},
            "peak": torch.cuda.max_memory_allocated(), "plan": sim.plan,
            "graph_block_reason": sim.engine.graph_block_reason()}


def _entry(torch, dev):
    """The device a virtual mesh repeats: ``cuda:0`` on the card."""
    return torch.device("cuda", 0) if dev.type == "cuda" else dev


def phase_parallel_mesh_cct2(torch, trimmed, fl, dev, card: str, log_root: Path) -> dict:
    """The main path unsharded, then on the virtual (2, 2) mesh of the card
    from the same seed: params and aggregates compared, the kernel on the
    column blocks, each launch held; the kernel timed at both block
    shapes."""
    k, d, b = CCT2_SHAPE
    t0 = time.perf_counter()
    plain = parallel_cct2_run(torch, trimmed, fl, log_root, "parallel_plain", False, device=dev)
    dev0 = _entry(torch, dev)
    mesh = parallel_cct2_run(torch, trimmed, fl, log_root, "parallel_mesh", True, device=dev,
                             mesh_shape=PARALLEL_MESH_SHAPE, mesh_devices=[dev0] * 4)
    diff = lambda a, b_: float((a.double() - b_.double()).abs().max())  # noqa: E731
    params_err = max(diff(mesh["params"][n], t) for n, t in plain["params"].items())
    agg_err = [diff(a, r) for a, r in zip(mesh["aggs"], plain["aggs"])]
    close = (all(torch.allclose(mesh["params"][n], t, **ROUND_TOL)
                 for n, t in plain["params"].items())
             and len(mesh["aggs"]) == len(plain["aggs"]) == PARALLEL_ROUNDS
             and all(torch.allclose(a, r, **ROUND_TOL)
                     for a, r in zip(mesh["aggs"], plain["aggs"])))
    bitwise = (all(torch.equal(mesh["params"][n], t) for n, t in plain["params"].items())
               and all(torch.equal(a, r) for a, r in zip(mesh["aggs"], plain["aggs"])))
    cols = [c.stop - c.start for c in mesh["plan"].column_ranges(d)]
    want_shapes = [(k, c) for c in cols] * PARALLEL_ROUNDS
    x, _ = mesh["first"]
    shapes = {(k, cols[0], b): kernel_timings(torch, trimmed, x, b, reps=3)}
    x = x[:, :cols[1]].contiguous()
    shapes[(k, cols[1], b)] = kernel_timings(torch, trimmed, x, b, reps=3)
    del x
    mesh["first"] = None
    emit({"phase": "parallel_mesh_cct2", "model": "cct_2_3x2_32", "dtype": "bfloat16",
          "clients": k, "byzantine": b, "chunks": CCT2_CHUNKS, "rounds": PARALLEL_ROUNDS,
          "mesh_shape": list(PARALLEL_MESH_SHAPE), "mesh": repr(mesh["plan"].mesh),
          "placed": {"unsharded": plain["placed"], "mesh": mesh["placed"]},
          "store_rows": mesh["store_rows"],
          "round_s": {"unsharded": plain["times"], "mesh": mesh["times"]},
          "warm_round_s": {"unsharded": plain["times"][-1], "mesh": mesh["times"][-1]},
          "peak_mem_bytes": {"unsharded": plain["peak"], "mesh": mesh["peak"]},
          "launches": {"unsharded": plain["launches"], "mesh": mesh["launches"]},
          "launch_shapes": {"unsharded": plain["shapes"], "mesh": mesh["shapes"]},
          "held": {"unsharded": plain["held"], "mesh": mesh["held"]},
          "max_abs_err": max(plain["err"], mesh["err"]),
          "elements_off_tol": plain["bad"] + mesh["bad"],
          "params_max_abs_diff": params_err, "agg_max_abs_diff": agg_err,
          "bar": ROUND_TOL, "bit_for_bit": bitwise,
          "graph_block_reason": mesh["graph_block_reason"],
          "note": "every mesh entry is cuda:0: each .to() is a no-op, so the mesh run "
                  "costs the partitioning alone (the column blocks' copies and the "
                  "extra launches), not transfers",
          "by_shape": [{"shape_kdb": list(s), **t} for s, t in shapes.items()],
          "seconds": time.perf_counter() - t0, "card": card})
    check(close and bitwise, f"parallel_mesh_cct2: the mesh run differs from the unsharded "
                             f"one (params {params_err}, aggregates {agg_err})")
    want_rows = [[r.start, r.stop, str(dev0)] for r in mesh["plan"].row_ranges(k)]
    check(not plain["placed"] and mesh["placed"] and mesh["store_rows"] == want_rows,
          f"parallel_mesh_cct2: placed {plain['placed']}, {mesh['placed']}, store rows "
          f"{mesh['store_rows']}, want {want_rows}")
    check(plain["launches"] == PARALLEL_ROUNDS and plain["shapes"] == [(k, d)] * PARALLEL_ROUNDS,
          f"parallel_mesh_cct2 unsharded: {plain['launches']} launches {plain['shapes']}")
    check(mesh["launches"] == 2 * PARALLEL_ROUNDS and mesh["shapes"] == want_shapes,
          f"parallel_mesh_cct2 mesh: {mesh['launches']} launches {mesh['shapes']}, "
          f"want {want_shapes}")
    check(mesh["held"] == mesh["launches"] and plain["held"] == plain["launches"]
          and plain["bad"] + mesh["bad"] == 0,
          f"parallel_mesh_cct2: launches held {plain['held']}, {mesh['held']}, "
          f"{plain['bad'] + mesh['bad']} elements off")
    return {"launches": mesh["launches"], "unsharded_launches": plain["launches"],
            "err": max(plain["err"], mesh["err"]), "shapes": shapes}


def phase_parallel_seq_text(torch, dev, card: str, beside_children: bool) -> dict:
    """The long-context example's model at PARALLEL_SEQ tokens on a virtual
    seq mesh of PARALLEL_SEQ_DEVICES entries: ring and Ulysses logits and
    one backward's gradients against the dense model, each model's warm
    forward and peak memory."""
    import torch.nn.functional as F

    from blades_tpu_torch.examples import long_context

    t0 = time.perf_counter()
    seq, batch = PARALLEL_SEQ, PARALLEL_SEQ_BATCH
    torch.cuda.empty_cache()
    mesh, models = long_context.build(seq, PARALLEL_SEQ_DEVICES, dev)
    tokens, mask = long_context.inputs(seq, batch, dev)
    labels = torch.arange(batch, device=dev) % 4
    out, grads, logits = {}, {}, {}
    for name, model in models.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fwd_ms = time_ms(lambda: model(tokens, None, mask), reps=3, warmup=1)
            logits[name] = model(tokens, None, mask)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(tokens, None, mask), labels).backward()
        torch.cuda.synchronize()
        out[name] = {"forward_ms": fwd_ms, "forward_peak_bytes": fwd_peak,
                     "backward_peak_bytes": torch.cuda.max_memory_allocated() - base}
        grads[name] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                       if p.grad is not None}
        model.zero_grad(set_to_none=True)
    for name in ("ring", "ulysses"):
        out[name]["logit_max_abs_diff"] = float((logits[name] - logits["dense"]).abs().max())
        rel = _leaf_rel_l2(torch, grads[name], grads["dense"])
        out[name]["grad_rel_l2_max"] = max(rel.values())
        out[name]["grad_leaves"] = len(rel)
        out[name]["grad_leaves_missing"] = sorted(set(grads["dense"]) - set(grads[name]))
    emit({"phase": "parallel_seq_text", "seq": seq, "batch": batch,
          "devices": PARALLEL_SEQ_DEVICES, "mesh": repr(mesh),
          "params": sum(p.numel() for p in models["dense"].parameters()),
          "logit_bar": PARALLEL_LOGIT_BAR, "grad_bar_rel_l2": PARALLEL_GRAD_REL_L2,
          "by_model": out, "seconds": time.perf_counter() - t0, "card": card,
          "beside_children": beside_children})
    for name in ("ring", "ulysses"):
        check(out[name]["logit_max_abs_diff"] < PARALLEL_LOGIT_BAR,
              f"parallel_seq_text {name}: logits off the dense model by "
              f"{out[name]['logit_max_abs_diff']}")
        check(out[name]["grad_rel_l2_max"] <= PARALLEL_GRAD_REL_L2
              and not out[name]["grad_leaves_missing"],
              f"parallel_seq_text {name}: gradients {out[name]}")
    del models, grads, logits
    return out


def start_parallel_children(torch, dev) -> dict:
    """The two NCCL children of ``parallel_dist_nccl``, each in a thread of
    its own, side by side: the multi-process worker as a one-rank NCCL job,
    and the ``multihost_pod`` example as a one-rank job of the launcher's
    environment."""
    import atexit
    import os
    import socket
    import threading

    from blades_tpu_torch.parallel import distributed as dist
    from blades_tpu_torch.parallel._dist_worker import run_local_cluster

    state = {}
    entry = _entry(torch, dev)

    def run_worker():
        t0 = time.perf_counter()
        try:
            state["dist"] = run_local_cluster(1, PARALLEL_DIST_DEVICES, timeout=300,
                                              backend=dist.backend_for(entry),
                                              device=str(entry))[0]
        except Exception as e:  # noqa: BLE001 - reported by the phase
            state["dist_error"] = f"{type(e).__name__}: {e}"[-3000:]
        state["dist_s"] = time.perf_counter() - t0

    def run_pod():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="1", RANK="0",
                   POD_ROUNDS=str(PARALLEL_POD_ROUNDS), POD_CLIENTS=str(PARALLEL_POD_CLIENTS))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "blades_tpu_torch.examples.multihost_pod",
             "--device", str(entry)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(proc.kill)  # should a phase fail before it ends
        try:
            out, err = proc.communicate(timeout=400)
            state["pod"] = {"returncode": proc.returncode, "stdout": out[-4000:],
                            "stderr": err[-3000:]}
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            state["pod"] = {"returncode": None, "stdout": out[-4000:], "stderr": "timed out"}
        state["pod_s"] = time.perf_counter() - t0

    threads = [threading.Thread(target=fn, daemon=True) for fn in (run_worker, run_pod)]
    for thread in threads:
        thread.start()
    return {"threads": threads, "state": state}


def join_parallel_children(children: dict) -> None:
    """Wait for :func:`start_parallel_children`'s two threads."""
    for thread in children["threads"]:
        thread.join(timeout=900)


def phase_parallel_dist_nccl(torch, trimmed, dev, card: str, children: dict) -> dict:
    """Wait for :func:`start_parallel_children`: the one-rank NCCL round
    against the same round in this process (the kernel held in both), and
    the pod example's rounds."""
    from blades_tpu_torch.parallel import distributed as dist
    from blades_tpu_torch.parallel import make_plan
    from blades_tpu_torch.parallel._dist_worker import make_data, round_summary, run_round

    join_parallel_children(children)
    state = children["state"]
    check("dist" in state, f"parallel_dist_nccl: the NCCL worker failed: "
                           f"{state.get('dist_error')}")
    res = state["dist"]
    entry = _entry(torch, dev)
    backend = dist.backend_for(entry)
    mesh = dist.make_global_mesh(local_devices=[entry] * PARALLEL_DIST_DEVICES)
    k = 2 * mesh.size
    cx, cy = (torch.from_numpy(a).to(dev) for a in make_data(k, 2, 4))
    with _HeldShapes(torch, trimmed) as held:
        trimmed.trimmed_mean_launches = 0
        local = round_summary(*run_round(make_plan(mesh), k, cx, cy, k // 4))
        torch.cuda.synchronize()
        local_launches = trimmed.trimmed_mean_launches
    n_held, err, bad = held.result()
    diffs = {key: abs(res[key] - v) for key, v in local.items()}
    pod = state.get("pod", {})
    losses = [float(x) for x in re.findall(r"round \d+: loss=(\S+)", pod.get("stdout", ""))]
    emit({"phase": "parallel_dist_nccl", "worker": res, "in_process": local,
          "abs_diff": diffs, "equal": all(v == 0 for v in diffs.values()),
          "worker_s": state.get("dist_s"), "in_process_launches": local_launches,
          "in_process_shapes": held.shapes, "in_process_held": n_held,
          "max_abs_err": max(err, res.get("max_abs_err", 0.0)),
          "pod": {"returncode": pod.get("returncode"), "losses": losses,
                  "seconds": state.get("pod_s"), "stdout": pod.get("stdout", "")[-600:],
                  "rounds": PARALLEL_POD_ROUNDS, "clients": PARALLEL_POD_CLIENTS},
          "two_rank_form": "not run: NCCL refuses two ranks on one device; it needs a "
                           "second card",
          "card": card})
    check(res["backend"] == backend and res["num_processes"] == 1
          and res["client_slice"] == [0, k], f"parallel_dist_nccl: worker {res}")
    check(all(d <= 1e-6 * max(1.0, abs(local[key])) for key, d in diffs.items()),
          f"parallel_dist_nccl: the NCCL round {res} differs from the in-process {local}")
    check(res.get("launches") == 1 and local_launches == 1 and n_held == 1 and bad == 0
          and res.get("max_abs_err", 1.0) <= TOL["atol"],
          f"parallel_dist_nccl: launches worker {res.get('launches')}, in process "
          f"{local_launches} (held {n_held}, {bad} off)")
    check(pod.get("returncode") == 0 and len(losses) == PARALLEL_POD_ROUNDS
          and all(math.isfinite(x) for x in losses) and f"backend {backend}" in pod["stdout"],
          f"parallel_dist_nccl: multihost_pod {pod}")
    return {"launches": res["launches"], "in_process_launches": local_launches,
            "err": max(err, res["max_abs_err"])}


def parallel_phases(torch, trimmed, dev, card: str, log_root: Path, fl=None,
                    children=None) -> dict:
    """The slice 12 phases on the CIFAR-shaped store ``fl`` (built here when
    None): the mesh round, then the sequence-parallel text model beside the
    NCCL children (started here unless ``children`` holds those of a
    :func:`start_parallel_children` call made before, which are waited for
    first: the card to this process alone for the timed phases), then
    their results."""
    if children is not None:
        join_parallel_children(children)
    t0 = time.perf_counter()
    if fl is None:
        fl = cct2_simulator(torch, log_root).dataset
    store_s = time.perf_counter() - t0
    mesh = phase_parallel_mesh_cct2(torch, trimmed, fl, dev, card, log_root)
    del fl
    gc.collect()
    torch.cuda.empty_cache()
    children = children or start_parallel_children(torch, dev)
    phase_parallel_seq_text(torch, dev, card,
                            beside_children=any(t.is_alive() for t in children["threads"]))
    gc.collect()
    torch.cuda.empty_cache()
    nccl = phase_parallel_dist_nccl(torch, trimmed, dev, card, children)
    emit({"phase": "parallel", "seconds": {"store": store_s,
                                           "total": time.perf_counter() - t0}, "card": card})
    return {"launches": {"parallel_mesh_cct2": mesh["launches"],
                         "parallel_mesh_cct2_unsharded": mesh["unsharded_launches"],
                         "parallel_dist_nccl": nccl["launches"],
                         "parallel_dist_nccl_in_process": nccl["in_process_launches"]},
            "err": max(mesh["err"], nccl["err"]), "shapes": mesh["shapes"]}


def relu_near_zero(torch, spec, params, x, eps: float = 1e-6) -> list:
    """``[within eps of 0, all]``: the ReLU inputs of a float64 forward of
    ``spec``'s model on the CPU, each a point where float32 rounding may
    take the other side."""
    from torch.overrides import TorchFunctionMode

    counts = [0, 0]

    class Count(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.nn.functional.relu:
                counts[0] += int((args[0].abs() < eps).sum())
                counts[1] += args[0].numel()
            return func(*args, **(kwargs or {}))

    with Count():
        spec.eval_logits_fn({n: t.double() for n, t in params.items()}, x.double())
    return counts


def start_other_build(src: Path, build_dir: Path):
    """Start ``nvcc`` on another source with the kernel's C interface and
    flags; returns the process and the library it writes."""
    from blades_tpu_torch.ops import _build

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / f"other-{digest}.so"
    proc = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def bind_other(torch, proc, lib: Path):
    """Wait for the other build; a launch function like trimmed_mean_cuda."""
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc failed on the other source:\n{log}")
    fn = ctypes.CDLL(str(lib)).blades_trimmed_mean_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x, b):
        k, d = x.shape
        out = torch.empty(d, dtype=torch.float32, device=x.device)
        status = fn(x.data_ptr(), out.data_ptr(), k, d, b, torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"other kernel launch failed: cudaError_t {status}")
        return out

    return launch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-with", type=Path, default=None,
                        help="another trimmed_mean.cu to time in turns with this one")
    parser.add_argument("--cpu-certify", default=None, metavar="OUT",
                        help="(the certify phase's CPU reference, run as a subprocess)")
    parser.add_argument("--text-cpu", default=None, metavar="OUT",
                        help="(the text_card_vs_cpu phase's CPU round, run as a subprocess)")
    parser.add_argument("--certify-only", action="store_true",
                        help="build the kernel, run only the certify_scale and certify "
                             "phases and print no result line")
    parser.add_argument("--vmap-only", action="store_true",
                        help="build the kernel, run only the experiments_vmap and remat "
                             "phases on stores of their own and print no result line")
    parser.add_argument("--text-only", action="store_true",
                        help="build the kernel, run only the text and pretrained phases "
                             "and print no result line")
    parser.add_argument("--resilient-only", action="store_true",
                        help="build the kernel, run a certify run on the card and the "
                             "slice 13a phases, and print no result line")
    parser.add_argument("--service-only", action="store_true",
                        help="build the kernel, run only the simulation service's phases, "
                             "then the kernels line and the result line")
    parser.add_argument("--pool-only", action="store_true",
                        help="build the kernel, run only the worker pool's phases, "
                             "service_kernel and the service drills, then the kernels line "
                             "and the result line")
    parser.add_argument("--drivers-only", action="store_true",
                        help="build the kernel, run only the reference CLI's and the "
                             "examples' phases (slice 15a), then the kernels line and the "
                             "result line")
    parser.add_argument("--analysis-only", action="store_true",
                        help="build the kernel and the CIFAR-shaped store, run only the "
                             "static linter's and the round-program auditor's phases "
                             "(slice 14), then the kernels line and the result line")
    parser.add_argument("--tools-only", action="store_true",
                        help="build the kernel and the CIFAR-shaped store, run only the "
                             "run-record readers', the last examples' and the LEAF tools' "
                             "phases (slice 15b), then the kernels line and the result line")
    parser.add_argument("--parallel-only", action="store_true",
                        help="build the kernel and the CIFAR-shaped store, run only the "
                             "parallel layer's phases (slice 12), then the kernels line "
                             "and the result line")
    parser.add_argument("--leaf-child", default=None, metavar="OUT",
                        help="(the tools_leaf phase's process: the LEAF tools, no torch)")
    parser.add_argument("--sticky-child", default=None, metavar="OUT",
                        help="(the resilient_sticky phase's supervised child)")
    args = parser.parse_args()
    if args.cpu_certify:
        return cpu_certify(args.cpu_certify)
    if args.text_cpu:
        return text_cpu(args.text_cpu)
    if args.sticky_child:
        return sticky_child(args.sticky_child)
    if args.leaf_child:
        return leaf_child(args.leaf_child)
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # no run of this script may append to a ledger outside its temporary
    # directory (below): until then the ledger is off
    os.environ["BLADES_LEDGER"] = "0"
    from concurrent.futures import ThreadPoolExecutor

    from blades_tpu_torch.ops import _build, trimmed
    from blades_tpu_torch.utils.platform import numerics, set_numerics

    # nvcc from here, beside the card's set-up
    t0 = time.perf_counter()
    build_pool = ThreadPoolExecutor(max_workers=1)
    building = build_pool.submit(_build.build, "trimmed_mean")
    whole = not any((args.certify_only, args.vmap_only, args.text_only, args.resilient_only,
                     args.service_only, args.pool_only, args.drivers_only, args.analysis_only,
                     args.tools_only, args.parallel_only))
    if whole:
        # the whole run's temporary directory (its ledger, logs and stores)
        # from the start, under the (git-ignored) build directory of the
        # checkout: the certify phase's CPU reference and the text
        # card-vs-CPU phase's CPU round start in it beside the build, which
        # keeps one core busy
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        run_dir = tempfile.TemporaryDirectory(dir=_build.BUILD_DIR)
        os.environ["BLADES_LEDGER"] = str(Path(run_dir.name) / "ledger.jsonl")
        cpu_cert = start_cpu_certify(Path(run_dir.name))
        text_cpu_run = start_text_cpu(Path(run_dir.name))
    dev = torch.device("cuda")
    set_numerics(matmul_allow_tf32=False, cudnn_allow_tf32=False)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "env", "device": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda, **numerics()})

    other_build = (start_other_build(args.compare_with.resolve(), _build.BUILD_DIR)
                   if args.compare_with else None)
    built = building.result()
    build_pool.shutdown()
    other = bind_other(torch, *other_build) if other_build else None
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built.seconds, "library": built.path.name,
          "ptxas": re.findall(r"(?:Compiling entry function|Used \d+ registers|"
                              r"\d+ bytes stack frame)[^\n]*", built.log)})

    if args.certify_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            phase_certify_scale(torch, trimmed, dev, card)
            phase_certify(torch, trimmed, dev, card, Path(tmp),
                          start_cpu_certify(Path(tmp)))
        return 0
    if args.vmap_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            vmap_phases(torch, trimmed, dev, card, Path(tmp))
        return 0
    if args.text_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            text_phases(torch, trimmed, dev, card, Path(tmp))
        return 0
    if args.resilient_only:
        from blades_tpu_torch.examples import certify

        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            ref = certify_on_card(torch, trimmed, certify, dev, Path(tmp) / "certify",
                                  count=False)
            resilient_phases(torch, trimmed, dev, card, Path(tmp), ref)
        return 0
    if args.service_only or args.pool_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            service = service_phases(torch, trimmed, dev, card, Path(tmp),
                                     pool_only=args.pool_only)
        check(service["launches"] > 0 and service["pool_launches"] > 0,
              "the service path ran without the kernel")
        by_path = {"service": service["launches"], "service_pool": service["pool_launches"]}
        emit({"kernels": [{
            "name": "trimmed_mean", "route": "cuda",
            "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
            "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape_kdb": list(SERVICE_SHAPE), "max_abs_err": service["err"],
            **service["timings"]}]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.drivers_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            drivers = drivers_phases(torch, trimmed, dev, card, Path(tmp))
        by_path = drivers["launches"]
        check(all(by_path.values()), f"a drivers path ran without the kernel: {by_path}")
        emit({"kernels": [{
            "name": "trimmed_mean", "route": "cuda",
            "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
            "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_under_drivers_off_kernel": drivers["off_kernel"],
            "shape_kdb": list(DRIVERS_CLI_SHAPE), "max_abs_err": drivers["err"],
            **drivers["timings"]}]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.analysis_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            analysis = analysis_phases(torch, trimmed, card, Path(tmp), keep_first=True)
            x, b = analysis.pop("first")
            k, d = x.shape
            timings = kernel_timings(torch, trimmed, x, b, reps=3)
            del x
            xs = torch.randn(VMAP_MLP_S, MAIN_CLIENTS, 59_850, device=dev)
            batched_timings = batched_kernel_timings(torch, trimmed, xs, MAIN_BYZANTINE)
            del xs
        by_path, batched = analysis["launches"], analysis["batched"]
        check(all(by_path.values()) and all(batched.values()),
              f"an analysis path ran without the kernel: {by_path} {batched}")
        emit({"kernels": [{
            "name": "trimmed_mean", "route": "cuda",
            "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
            "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape_kdb": [k, d, b], "max_abs_err": analysis["err"], **timings}, {
            "name": "trimmed_mean_batched", "route": "cuda",
            "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
            "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
            "launches": sum(batched.values()), "launches_by_path": batched,
            "shape_skdb": [VMAP_MLP_S, MAIN_CLIENTS, 59_850, MAIN_BYZANTINE],
            "max_abs_err": analysis["err"], **batched_timings}]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.tools_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            tools = tools_phases(torch, trimmed, card, Path(tmp), keep_first=True)
        by_path = tools["launches"]
        check(all(by_path.values()), f"a tools path ran without the kernel: {by_path}")
        emit({"kernels": [{
            "name": "trimmed_mean", "route": "cuda",
            "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
            "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "launches_under_tools_off_kernel": tools["off_kernel"],
            "shape_kdb": list(CCT2_SHAPE), "max_abs_err": tools["err"],
            **tools["shapes"][CCT2_SHAPE],
            "by_shape": [{"shape_kdb": list(s), **t} for s, t in tools["shapes"].items()]}]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    if args.parallel_only:
        with tempfile.TemporaryDirectory(dir=built.path.parent) as tmp:
            os.environ["BLADES_LEDGER"] = str(Path(tmp) / "ledger.jsonl")
            parallel = parallel_phases(torch, trimmed, dev, card, Path(tmp))
        by_path = parallel["launches"]
        check(all(by_path.values()), f"a parallel path ran without the kernel: {by_path}")
        (k, c0, b), t0 = next(iter(parallel["shapes"].items()))
        emit({"kernels": [{
            "name": "trimmed_mean", "route": "cuda",
            "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
            "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "shape_kdb": [k, c0, b], "max_abs_err": parallel["err"], **t0,
            "by_shape": [{"shape_kdb": list(s), **t}
                         for s, t in parallel["shapes"].items()]}]})
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    max_err, timings = phase_kernel(torch, trimmed, dev, card, other)
    with run_dir as tmp:
        # the text models (slice 11b) first, on a card nothing else has
        # used yet: text_cct_2 at K=100 peaks at 61 GB in one chunk, and
        # after the later phases the allocator's cache (about 1.5 GB still
        # held, and partly used segments) left it 0.2 GB short; the kernel
        # once a round on [100, 30352643], eager and in a graph block; the
        # streaming round at K=1000 never launches it
        text = text_phases(torch, trimmed, dev, card, Path(tmp), text_cpu_run)
        launches = dict(text["launches"])
        launches["mlp_k1000"], sim = phase_main_path(torch, trimmed, dev, card, Path(tmp))
        phase_profile(torch, trimmed, sim, card, other)
        phase_card_vs_cpu(torch, dev)
        launches["config1"] = phase_config1(torch, trimmed, dev, card, Path(tmp))
        mlp_fl = sim.dataset  # the MNIST-shaped store of the block phases
        del sim
        sim = cct2_simulator(torch, Path(tmp))
        runs = phase_cct2_path(torch, trimmed, sim, card)
        phase_cct2_profile(torch, sim, runs, card)
        fl = sim.dataset  # the CIFAR-shaped store, already on the card
        del sim, runs["float32"]["engine"], runs["bfloat16"]["engine"]
        launches.update(phase_catalog_attacks(torch, trimmed, fl, card, Path(tmp)))
        sample = phase_catalog_aggregators(torch, trimmed, fl, card, Path(tmp))
        fault_launches = phase_fault_round(torch, trimmed, fl, card, Path(tmp))
        fault_sample = phase_fault_aggregators(torch, trimmed, fl, card, Path(tmp))
        # the streaming round: the dense paths launch the kernel, the
        # streaming ones never do
        stream_launches = {"text_stream": text["stream"]}
        launches["cct2_bf16_stream_round_dense"], stream_launches["stream_round"] = (
            phase_stream_round(torch, trimmed, fl, card, Path(tmp)))
        stream_launches["stream_exact"] = phase_stream_exact(torch, trimmed, fl, card, Path(tmp))
        stream_launches.update(phase_stream_aggregators(torch, trimmed, fl, card, Path(tmp)))
        stream_launches["stream_fault"] = phase_stream_fault(torch, trimmed, fl, card, Path(tmp))
        # composite attacks and persistent client state launch the kernel
        # once a round; the async round launches it only on its static
        # zero-delay path
        launches.update(phase_composite_round(torch, trimmed, fl, card, Path(tmp)))
        launches.update(phase_persist_round(torch, trimmed, fl, card, Path(tmp)))
        async_launches = {}
        async_launches["async_static"], launches["cct2_bf16_async_static_sync"], sync_peak = (
            phase_async_static(torch, trimmed, fl, card, Path(tmp)))
        async_launches["async_round"] = phase_async_round(torch, trimmed, fl, card, Path(tmp),
                                                          sync_peak)
        agg_launches = phase_async_aggregators(torch, trimmed, fl, card, Path(tmp))
        async_launches.update({n: v for n, v in agg_launches.items() if n.startswith("async")})
        stream_launches.update({n: v for n, v in agg_launches.items() if n.startswith("stream")})
        async_launches["async_fault"] = phase_async_fault(torch, trimmed, fl, card, Path(tmp))
        # round blocks: a graph or an eager block against the same rounds one
        # by one, bit for bit (cuDNN's deterministic algorithms on)
        with deterministic_cudnn():
            graph_launches, graph_events = phase_block_mlp(torch, trimmed, mlp_fl, card,
                                                           Path(tmp))
            graph_launches["text_cct2_bf16_block"] = text["block"]
            cct2_blocks, cct2_events = phase_block_cct2(torch, trimmed, fl, card, Path(tmp))
            graph_launches.update(cct2_blocks)
            graph_events.update(cct2_events)
            launches.update(cct2_blocks)
            block_bypass = phase_block_fault_async(torch, trimmed, fl, card, Path(tmp))
            phase_block_linkage(torch, trimmed, fl, card, Path(tmp))
            phase_block_eager(torch, trimmed, fl, card, Path(tmp))
            graph_launches["mlp_k1000_experiments"] = phase_experiments(
                torch, trimmed, mlp_fl, card, Path(tmp))
            launches["cct2_bf16_donate"] = phase_donate(torch, trimmed, fl, card, Path(tmp))
            # in-round forensics: the kernel twice a round (the defense and
            # the audit's fallback), eager and in a graph block; the
            # streaming forms never launch it
            forensics, forensics_events = phase_forensics_round(torch, trimmed, fl, card,
                                                                Path(tmp))
            launches.update(forensics)
            graph_launches.update({n: v for n, v in forensics.items() if "block" in n})
            graph_events.update(forensics_events)
            stream_forensics = phase_stream_forensics(torch, trimmed, fl, card, Path(tmp))
            launches["cct2_bf16_forensics_dense_median_fallback"] = stream_forensics["dense"]
            stream_launches["stream_forensics"] = stream_forensics["stream"]
            # the run's own records (slice 10b): the ledger, alerts, timeline
            # and heartbeat on the main path, eager and in a graph block
            records = phase_run_records(torch, trimmed, fl, card, Path(tmp))
            launches["cct2_bf16_run_records"] = records["cct2_bf16_run_records"]
            graph_launches["cct2_bf16_run_records_block"] = records[
                "cct2_bf16_run_records_block"]
            # real data from files and resume: the CIFAR-10 round (kernel
            # once a round, eager and in a graph block), the MNIST MLP and
            # the mini example, then checkpoint and resume under faults
            data = Path(tmp) / "data"
            cifar, data_launches, data_graph, data_events = phase_data_cifar10(
                torch, trimmed, dev, fl, card, Path(tmp), data / "cifar10")
            launches.update(data_launches)
            graph_launches.update(data_graph)
            graph_events.update(data_events)
            launches["mlp_k1000_mnist_files"] = phase_data_mnist(torch, trimmed, dev, card,
                                                                 Path(tmp), data / "mnist")
            fault_launches.update(phase_checkpoint(torch, trimmed, cifar, card, Path(tmp), data))
            del cifar
        del fl, mlp_fl
        # the BASELINE models (slice 11a): ResNet-18 at K=100 (the kernel
        # once a round under ALIE + trimmed mean, eager and in a graph
        # block), IPM + Krum, and the streaming rounds of ResNet-18 and
        # WideResNet-28-10 at K=1000, which never launch it
        # slice 15b's LEAF pipeline, host work only, in a process of its own
        # from here on: beside the BASELINE phases, whose rounds keep the
        # card busy while the host waits (beside the host-bound drivers
        # phases it doubled drivers_config1 on a slow host)
        leaf = start_leaf(Path(tmp))
        stores = baseline_stores(torch, dev, Path(tmp) / "baseline_data")
        baseline = phase_resnet18_round(torch, trimmed, stores["cifar10_k100"], card, Path(tmp))
        (launches["resnet18_bf16_alie_trimmedmean"], graph_launches["resnet18_bf16_block"],
         resnet_timings, resnet_err) = phase_resnet18_kernel(
            torch, trimmed, stores["cifar10_k100"], card, Path(tmp))
        baseline["resnet18_krum"] = phase_resnet18_krum(torch, trimmed, stores["cifar10_k100"],
                                                        card, Path(tmp))
        stream_launches["resnet18_stream"] = phase_resnet18_stream(
            torch, trimmed, stores["cifar10_k1000"], card, Path(tmp))
        stream_launches["wrn_stream"] = phase_wrn_stream(torch, trimmed, stores["cifar100"],
                                                         card, Path(tmp))
        del stores
        # supervised_cct2's uninterrupted child (slice 13a), a reference
        # whose wall no claim rests on, from here beside the card-vs-CPU
        # phases, which leave the card nearly idle (the supervised run it
        # is held to starts in resilient_phases, after it)
        gc.collect()
        torch.cuda.empty_cache()
        sup_ref = start_sup_reference(Path(tmp))
        phase_resnet_card_vs_cpu(torch, dev, card)
        launches["cct2_bf16_k4000_dense"], stream_launches["stream_scale"] = (
            phase_stream_scale(torch, trimmed, dev, card, Path(tmp)))
        phase_cct2_card_vs_cpu(torch, dev)
        phase_catalog_card_vs_cpu(torch, sample, dev)
        phase_fault_card_vs_cpu(torch, *fault_sample, dev)
        phase_stream_card_vs_cpu(torch, *fault_sample, dev)
        phase_async_card_vs_cpu(torch, dev)
        # defense certification (slice 10b): the scale cells, then the
        # certify script on the CPU and on the card, one after the other
        launches["certify_scale"], cert_timings, cert_err = phase_certify_scale(
            torch, trimmed, dev, card)
        launches["certify"], search_shapes, search_err, cert_ref = phase_certify(
            torch, trimmed, dev, card, Path(tmp), cpu_cert)
        # vmap mode (slice 7b): the kernel's batched entry once a round for
        # S experiments, against S launches in map mode; remat (slice 2b) on
        # the CCT-2 round. Last, on stores of their own: ahead of the
        # BASELINE phases their graphs and batched rounds left the
        # allocator too fragmented for WRN-28-10's streaming round (47.7 GB
        # reserved and unused)
        batched_launches, batched_timings, batched_err = vmap_remat_phases(
            torch, trimmed, dev, card, Path(tmp))
        # resilient sweeps and the run supervisor (slice 13a): the kernel
        # launched again after a failure (a quarantine's bisection, an OOM's
        # bisection, a relaunched process), each launch held against its
        # plain version
        resilient = resilient_phases(torch, trimmed, dev, card, Path(tmp), cert_ref,
                                     sup_ref=sup_ref)
        launches.update(resilient["launches"])
        # the simulation service (slices 13b.1, 13b.2): the main path's MLP
        # served cold and warm by a server process and by its worker pool
        # (every launch in a worker held), the same request in this
        # process (the kernel 3 times a request, each launch held), the
        # certify driver as a tenant and the service drills
        service = service_phases(torch, trimmed, dev, card, Path(tmp))
        launches["service"] = service["launches"]
        # the worker pool (slice 13b.2): the launches held in its workers
        launches["service_pool"] = service["pool_launches"]
        # the reference CLI and the JAX examples (slice 15a): the CLI's
        # CCT-2 run at K=20 (the kernel once a round at [20, 283723], b=8),
        # config 1, the IPM sweep, the matrix's kernel column and the dense
        # half of the streaming demo, each launch held
        drivers = drivers_phases(torch, trimmed, dev, card, Path(tmp))
        launches.update(drivers["launches"])
        # a CIFAR-shaped store of the last three slices' own. First on it,
        # with nothing beside it, the run-record readers' trace (slice
        # 15b): the telemetry example's recipe on the main path (the kernel
        # once a round, held), read back by the port's trace reader (the
        # per-stage table of PERF.md)
        t_store = time.perf_counter()
        store = cct2_simulator(torch, Path(tmp)).dataset
        emit({"phase": "store_cct2", "seconds": time.perf_counter() - t_store, "card": card})
        trace = phase_tools_trace_cct2(torch, trimmed, store, card, Path(tmp), False)
        # the parallel phases' two NCCL children (slice 12), host-bound
        # process starts and a small pod, from here beside the analysis
        # phases, the examples and the readers, which time nothing that a
        # claim rests on; waited for before the kernel's timings and the
        # timed parallel phases
        parallel_children = start_parallel_children(torch, dev)
        # the static linter and the round-program auditor (slice 14): the
        # toy programs of Tier B and the CCT-2 round and block audited on
        # the store, each launch held (those in a graph after each
        # replay). Late: ahead of the BASELINE phases the CCT-2 block's
        # graph left the allocator too fragmented for wrn_stream (47.58 GB
        # reserved and unused at its OOM)
        analysis = analysis_phases(torch, trimmed, card, Path(tmp), fl=store)
        launches.update(analysis["launches"])
        # the rest of slice 15b: the examples, the aggregator comparison's
        # [100, 2] launch among them; the readers over this run's ledger
        # and traces; the LEAF pipeline on the host beside them
        del analysis["store"]
        tools = tools_phases(torch, trimmed, card, Path(tmp), leaf=leaf, trace=trace,
                             settle=lambda: join_parallel_children(parallel_children))
        launches.update(tools["launches"])
        # the parallel layer (slice 12), last, on the same store: the main
        # path on a virtual (2, 2) mesh (the kernel on each column block,
        # held), the long-context model's ring and Ulysses attention on a
        # virtual seq mesh of 8, and one-rank NCCL jobs (the worker's round,
        # the kernel held in it, and the pod example)
        parallel = parallel_phases(torch, trimmed, dev, card, Path(tmp), fl=store,
                                   children=parallel_children)
        del store
        launches.update(parallel["launches"])
    for dtype, run in runs.items():
        launches[f"cct2_{dtype}"] = run["launches"]
        max_err = max(max_err, run["max_abs_err"])
    max_err = max(max_err, resnet_err, cert_err, search_err, text["err"], resilient["err"],
                  service["err"], drivers["err"], analysis["err"], tools["err"],
                  parallel["err"])
    batched_launches.update(analysis["batched"])
    check(all(launches.values()), f"a path ran without the kernel: {launches}")
    check(all(n > 0 for p, n in batched_launches.items() if "fault" not in p and
              "geomed" not in p) and not any(n for p, n in batched_launches.items()
                                            if "fault" in p or "geomed" in p),
          f"batched launches: {batched_launches}")
    check(not any(stream_launches.values()), f"a streaming path launched it: {stream_launches}")
    check(resilient["chaos"] == 0, f"the chaos sweep launched it: {resilient['chaos']}")
    check(async_launches["async_static"] > 0 and not any(
        n for p, n in async_launches.items() if p != "async_static"),
        f"async launches: {async_launches}")

    # the main paths are the CCT-2 round, under ALIE in f32 and bf16 and
    # under each catalog attack in bf16, the ResNet-18 round under ALIE +
    # trimmed mean, the certification sweep and scale cell, and the text
    # round (K*D past 2^31) in f32 and bf16:
    # their launches, and the kernel timed at CCT-2's [K, D, b] (the
    # top-level times) and at each path's shape
    cert_shape = (CERT_SCALE_CLIENTS, CCT2_SHAPE[1], CERT_SCALE_B)
    shapes = {CCT2_SHAPE: timings[CCT2_SHAPE], RESNET18_SHAPE: resnet_timings,
              cert_shape: cert_timings, TEXT_SHAPE: text["timings"], **search_shapes,
              SERVICE_SHAPE: service["timings"], DRIVERS_CLI_SHAPE: drivers["timings"],
              **tools["shapes"], **parallel["shapes"]}
    emit({"kernels": [{
        "name": "trimmed_mean",
        "route": "cuda",
        "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
        "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
        "launches": sum(n for path, n in launches.items()
                        if path.startswith(("cct2", "resnet18", "certify", "text", "resilient",
                                            "supervised", "service", "drivers",
                                            "analysis", "tools", "parallel"))),
        "launches_by_path": launches,
        # the BASELINE models' paths that take another defense (mean, Krum)
        "launches_under_baseline_models": baseline,
        # under a fault model the masked trimmed mean replaces the kernel
        "launches_under_fault_model": fault_launches,
        # the streaming round's chunks take the masked trimmed mean, as the
        # JAX package's streaming round never reaches its Pallas kernel
        "launches_under_streaming": stream_launches,
        # the async round's static zero-delay path makes the sync round's
        # unmasked call; its general ticks take the masked trimmed mean
        "launches_under_async": async_launches,
        # round blocks replayed as CUDA graphs: launches counted (one a
        # replay, as captured) by path, and torch.profiler's kernel events
        # in the profiled warm blocks beside their counted launches; the
        # fault and async blocks take the masked trimmed mean
        "launches_under_graph": graph_launches,
        "launches_under_graph_profiler_events": graph_events,
        "launches_under_graph_bypassed": block_bypass,
        # the forensics path (slice 10a): the defense and the audit's
        # fallback, 2 a round, eager and replayed
        "launches_under_forensics": forensics,
        # the chaos sweep runs every scenario under fault weather: the
        # masked forms, no launch
        "launches_under_chaos": resilient["chaos"],
        # the examples of slice 15a whose defense is not the dense trimmed
        # mean (the fault model's masked form among them): no launch
        "launches_under_drivers_off_kernel": drivers["off_kernel"],
        # the examples of slice 15b whose defenses are not the trimmed mean
        # (run_ledger's median, defense_audit's four and its fallback,
        # fedavg_ipm's mean and Krum): no launch
        "launches_under_tools_off_kernel": tools["off_kernel"],
        # the certification paths (slice 10b): every unmasked trimmed-mean
        # evaluation of the search with 1 <= b <= 16 ("certify", K=8, and
        # "certify_scale", K=100 at b=10) and the battery's contract calls;
        # by_shape holds the kernel at each of their [K, D, b]
        "shape_kdb": list(CCT2_SHAPE),
        "max_abs_err": max_err,
        **timings[CCT2_SHAPE],
        "by_shape": [{"shape_kdb": list(shape), **t} for shape, t in shapes.items()],
    }, {
        # the batched entry (ExperimentBatch(mode="vmap"); JAX's vmap of the
        # pallas_call adds a grid axis): one launch for S experiments' [K, D]
        # slabs, timed at [8, 1000, 59850], b=5, beside 8 single launches
        "name": "trimmed_mean_batched",
        "route": "cuda",
        "source": "blades_tpu_torch/csrc/trimmed_mean.cu",
        "replaces": "blades_tpu/ops/pallas_trimmed.py:91",
        "launches": sum(batched_launches.values()),
        "launches_by_path": batched_launches,
        "shape_skdb": [VMAP_MLP_S, MAIN_CLIENTS, 59_850, MAIN_BYZANTINE],
        "max_abs_err": batched_err,
        **batched_timings,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
