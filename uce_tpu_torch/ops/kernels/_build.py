"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Sources live in ``uce_tpu_torch/csrc``. Each shared library is compiled
with ``nvcc`` for ``sm_90a`` into ``build/uce_tpu_torch/<hash>/`` at the
root of the checkout, keyed by a hash of its sources and of the shared
headers (``csrc/*.cuh``), so an edited source rebuilds and an unchanged one
loads from the cache. Each kernel has its own library, so editing one
source rebuilds only that one. ptxas's report of each kernel's registers,
shared memory and spills (``-Xptxas -v``) is kept in ``build_logs`` for
each library compiled in this process. ``launch_on`` gives a wrapper the
device context and raw stream of a launch at a few microseconds' cost,
``sm_count`` a card's SM count.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "uce_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_sm_counts: dict[int, int] = {}
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """Where lib<name>.so of the current ``sources`` (file names under
    csrc/), headers and flags is built (it may not exist yet)."""
    digest = hashlib.sha256()
    for p in [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into lib<name>.so once
    and return the loaded library."""
    if name in _loaded:
        return _loaded[name]
    paths = [CSRC / s for s in sources]
    lib_path = library_path(name, sources)
    out_dir = lib_path.parent
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
        build_logs[name] = proc.stderr
    _loaded[name] = ctypes.CDLL(str(lib_path))
    return _loaded[name]


def launch_on(device: torch.device):
    """(context, stream) for a kernel launch on ``device``: a context that
    makes the device current only when it is not already (entering
    ``torch.cuda.device`` costs microseconds), and PyTorch's current raw
    stream there as an int."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(index) if raw else torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        return contextlib.nullcontext(), stream
    return torch.cuda.device(index), stream


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device`` (looked up once per card)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]
