"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

No counterpart in ``blades_tpu``: the Pallas kernel there is compiled by
Mosaic inside ``jax.jit``. Here each ``csrc/<name>.cu`` has a plain C
interface and is compiled into a shared library for Hopper (``sm_90a``),
loaded with ``ctypes``; the caller declares each function's ``argtypes``
(``c_void_p`` for pointers and the stream). A build that includes PyTorch's
headers (``torch.utils.cpp_extension.load``) takes minutes; this one takes
seconds (about 33 s for the 16 instantiations of ``trimmed_mean.cu`` on an
H100 machine).

The library lands in ``build/blades_tpu_torch/`` at the root of the
checkout, named by a hash of every source under ``csrc/`` and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused. A
missing ``nvcc`` raises; there is no fallback. Each :func:`build` counts,
on the process counters of ``telemetry/recorder.py``, an ``nvcc`` run
(``cuda.kernel_builds`` and its seconds) or a reused library
(``cuda.kernel_reuses``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

from blades_tpu_torch.telemetry.recorder import count_process

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "blades_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into the build log
)

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was already on disk
    log: str  # nvcc's output (ptxas resource usage); "" when reused


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: blades_tpu_torch builds its CUDA kernels from "
            "csrc/ at first use and needs the CUDA toolkit on PATH or in "
            "/usr/local/cuda"
        )
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` into ``build/blades_tpu_torch/`` unless an
    up-to-date library is already there."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    lib = BUILD_DIR / f"{name}-{_digest()}.so"
    if lib.exists():
        count_process("cuda.kernel_reuses")
        return Build(lib, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    count_process("cuda.kernel_builds")
    count_process("cuda.kernel_build_s", seconds)
    return Build(lib, seconds, proc.stdout + proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return _LOADED[name]
