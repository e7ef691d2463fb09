#!/usr/bin/env python3
"""Where the trimmed-mean kernel's time goes, stage by stage, on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 kernel_stages.py

It builds a copy of ``blades_tpu_torch/csrc/trimmed_mean.cu`` into
``build/blades_tpu_torch/`` with an exit after each stage of the kernel
(0: the tile copied into shared memory; 1: the lane extremes; 2: the pass
that gathers both candidate lists; 3: the whole kernel) and counters of the
blocks that gathered more than once and of the columns that took the
general route. It times each stage with CUDA events at the main path's
shapes, beside two PyTorch calls that read the matrix once (``x.sum(0)``,
``x.clone()``), and prints one JSON line per shape. The copy is for
measurement only; the port never loads it. Without CUDA it exits non-zero.

Imports nothing of JAX or of the JAX package ``blades_tpu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# [K, D, b, ALIE-style identical rows 0..b]
SHAPES = [(1000, 59_850, 5, True), (1000, 59_850, 16, True), (1000, 59_850, 16, False),
          (10, 59_850, 4, True), (10, 59_850, 4, False)]

# (anchor in the source, replacement): an exit after each stage, the
# counters, and the stage and counter arguments threaded to the launch
PATCH = [
    ("int64_t D,\n                        int R) {",
     "int64_t D,\n                        int R, int stage, unsigned* dbg) {"),
    ("  if (R >= K) load_rows(t, 0, K);\n",
     "  if (R >= K) load_rows(t, 0, K);\n"
     "  if (stage == 0) { if (threadIdx.x < t.ncols) out[col0 + threadIdx.x] = tile_smem[threadIdx.x];"
     " return; }\n"),
    ("  float thr_t[kSlots], thr_b[kSlots], acc[kSlots];",
     "  if (stage == 1) { for (int s = 0; s < kSlots; ++s) { if (lane == 0 && active[s])"
     " out[col0 + warp + s * kWarps] = lmax[s] + lmin[s]; } return; }\n"
     "  int passes = 0;\n  float thr_t[kSlots], thr_b[kSlots], acc[kSlots];"),
    ("  while (__syncthreads_or(any_slot(again))) {\n",
     "  while (__syncthreads_or(any_slot(again))) {\n    ++passes;\n"),
    ("  // 3. rank the lists:",
     "  if (threadIdx.x == 0 && passes > 1) atomicAdd(dbg + 0, 1u);\n"
     "  for (int s = 0; s < kSlots; ++s) if (lane == 0 && general[s]) atomicAdd(dbg + 1, 1u);\n"
     "  if (stage == 2) { for (int s = 0; s < kSlots; ++s) { if (lane == 0 && active[s])"
     " out[col0 + warp + s * kWarps] = acc[s]; } return; }\n  // 3. rank the lists:"),
    ("unsigned n, cudaStream_t s) {", "unsigned n, cudaStream_t s, int stage, unsigned* dbg) {"),
    ("(x, out, K, d, R);", "(x, out, K, d, R, stage, dbg);"),
    ("int64_t d, int b, void* stream) {", "int64_t d, int b, void* stream, int stage, unsigned* dbg) {"),
    ("launch<N>(x, out, K, d, n32, s)", "launch<N>(x, out, K, d, n32, s, stage, dbg)"),
    ("                                       void* stream) {",
     "                                       void* stream, int stage, unsigned* dbg) {"),
    ("(x, out, 1, k, d, b, stream);", "(x, out, 1, k, d, b, stream, stage, dbg);"),
]


def staged_source() -> str:
    src = (ROOT / "blades_tpu_torch" / "csrc" / "trimmed_mean.cu").read_text()
    for anchor, replacement in PATCH:
        if src.count(anchor) != 1:
            raise RuntimeError(f"kernel_stages: anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, replacement)
    return src


def build(torch_build) -> ctypes.CDLL:
    src = staged_source()
    out_dir = torch_build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(src.encode()).hexdigest()[:16]
    cu, lib = out_dir / f"stages-{digest}.cu", out_dir / f"stages-{digest}.so"
    cu.write_text(src)
    proc = subprocess.run([torch_build.find_nvcc(), *torch_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the staged copy:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).blades_trimmed_mean_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_stages: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from blades_tpu_torch.ops import _build
    from blades_tpu_torch.ops.trimmed import trimmed_mean_plain

    card = chip_smoke.card_line()
    print(card, flush=True)
    fn = build(_build)
    g = torch.Generator(device="cuda").manual_seed(0)
    counters = torch.zeros(2, dtype=torch.int32, device="cuda")
    for k, d, b, alie in SHAPES:
        x = torch.randn(k, d, generator=g, device="cuda") * 1e-2
        if alie:
            x[: b + 1] = x[0]
        out = torch.empty(d, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def run(stage):
            status = fn(x.data_ptr(), out.data_ptr(), k, d, b, stream, stage, counters.data_ptr())
            chip_smoke.check(status == 0, f"staged launch failed: cudaError_t {status}")

        counters.zero_()
        run(3)
        torch.cuda.synchronize()
        err = float((out - trimmed_mean_plain(x, b)).abs().max())
        regathered, general = counters.tolist()
        chip_smoke.check(err <= 1e-5, f"staged copy differs from the plain version by {err}")
        stages = {s: chip_smoke.time_ms(lambda: run(s), reps=30) for s in (0, 1, 2, 3)}
        print(json.dumps({
            "shape": [k, d, b], "alie_rows": alie, "max_abs_err": err,
            "blocks": (d + 15) // 16, "blocks_gathered_again": regathered,
            "general_route_columns": general, "stage_ms": stages,
            "sum0_ms": chip_smoke.time_ms(lambda: x.sum(0), reps=30),
            "clone_ms": chip_smoke.time_ms(lambda: x.clone(), reps=30),
            "bound_ms": chip_smoke.bound_ms(k, d)[0], "card": card,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
