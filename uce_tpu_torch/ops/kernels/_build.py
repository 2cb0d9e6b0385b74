"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Sources live in ``uce_tpu_torch/csrc``. Each shared library is compiled
with ``nvcc`` for ``sm_90a`` into ``build/uce_tpu_torch/<hash>/`` at the
root of the checkout, keyed by a hash of its sources and of the shared
headers (``csrc/*.cuh``), so an edited source rebuilds and an unchanged one
loads from the cache. Each kernel has its own
library, so editing one source rebuilds only that one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "uce_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into lib<name>.so once
    and return the loaded library."""
    if name in _loaded:
        return _loaded[name]
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256()
    for p in paths + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / f"lib{name}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - start
    _loaded[name] = ctypes.CDLL(str(lib_path))
    return _loaded[name]
