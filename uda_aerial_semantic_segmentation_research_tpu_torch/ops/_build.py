"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  On first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the root of the checkout and loaded
with ``ctypes``; ``build_libraries`` compiles several sources at once,
one ``nvcc`` process each.  The library's file name carries a hash of its
source, of every header under ``csrc/`` and of the ``nvcc`` flags, so an
edited source, header or flag is rebuilt and a stale library is never loaded.
Nothing is built at import time: the CPU tests import every module on
a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# seconds spent in nvcc per library in this process (0.0 when cached on disk)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(src: Path) -> str:
    """Hash of what a library is built from: its source, the headers it may
    include and the compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_libraries(names) -> dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose hashed library is
    missing, all ``nvcc`` processes started together, and return the paths."""
    outs, running = {}, {}
    for name in names:
        src = CSRC_DIR / f"{name}.cu"
        digest = _digest(src)
        out = outs[name] = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[name] = (proc, src, tmp, time.perf_counter())
    failures = []
    for name, (proc, src, tmp, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {src}:\n{log}")
            continue
        os.replace(tmp, outs[name])  # atomic: a concurrent process never loads a partial file
        build_seconds[name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process; never
    during CUDA graph capture."""
    from uda_aerial_semantic_segmentation_research_tpu_torch.utils.device import (
        refuse_under_capture,
    )

    refuse_under_capture(f"building or loading the {name} library")
    return ctypes.CDLL(str(build_libraries([name])[name]))
