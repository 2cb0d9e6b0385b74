"""The port's hand-written CUDA kernels, and the one registry of them: the
libraries ``build_all`` compiles, the launch counters that the wrappers
bump (``count``) and ``launches`` reads, and ``route``, which switches
kernels off for the enclosed calls.

Each library is built from ``csrc/<name>.cu`` (``_build``). A counter is
named after its kernel (``KERNELS``, the ``pipe.model`` span's attrs:
``sd_attention`` counts the bf16 launches) or after a variant of it: the
conv's wgmma and mma.sync kernels and its split-K sums, the bf16
attention's launches by head dim, its d=512 split merge and its int8-QK^T
kernel. A switched-off kernel's call sites take its plain version (the
convs and GroupNorms the library calls, NCHW): a switch for tests and
diagnostics, which nothing on the program's paths sets.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

LIBRARIES = ("conv3x3", "group_norm", "qk_norm_rope", "sd_attention",
             "sd_attention_d512", "sd_attention_qk8", "uce_solve")
# the kernels the models route to (``route``), by the names of their counters
KERNELS = ("conv3x3", "group_norm_act", "sd_attention", "qk_norm_rope")
COUNTERS = (*KERNELS, "conv3x3_wgmma", "conv3x3_mma", "conv3x3_reduce",
            *(f"sd_attention_d{d}" for d in (40, 64, 80, 128, 160, 512)),
            "sd_attention_d512_merge", "sd_attention_qk8", "uce_solve")

_counts = dict.fromkeys(COUNTERS, 0)
_off: frozenset = frozenset()


def build_all() -> None:
    """Compile (or load from the build cache) every library, one nvcc each,
    all started together."""
    from uce_tpu_torch.ops.kernels._build import load_library

    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        for future in [pool.submit(load_library, name, (f"{name}.cu",))
                       for name in LIBRARIES]:
            future.result()


def count(*names: str, n: int = 1) -> None:
    """``n`` launches on each of the counters ``names``."""
    for name in names:
        _counts[name] += n


def launches() -> dict[str, int]:
    """Every counter's launches since the last ``reset_launches`` (the
    difference over a call counts that call's)."""
    return dict(_counts)


def reset_launches() -> None:
    """Every counter to 0."""
    for name in _counts:
        _counts[name] = 0


def on(*names: str) -> bool:
    """Whether none of the kernels ``names`` (of ``KERNELS``) is switched
    off by ``route``: the first question of each of their call sites."""
    return _off.isdisjoint(names)


@contextlib.contextmanager
def route(off=KERNELS):
    """The enclosed calls with the kernels ``off`` (every kernel by
    default) switched off, on their plain versions."""
    global _off
    unknown = set(off) - set(KERNELS)
    if unknown:
        raise ValueError(f"route: unknown kernels {sorted(unknown)}, not in {KERNELS}")
    saved, _off = _off, _off | frozenset(off)
    try:
        yield
    finally:
        _off = saved
