"""GroupNorm (+SiLU) over NHWC bf16 maps: the hand-written Hopper kernel and
its plain PyTorch version.

``group_norm_act`` takes ``uce_tpu/ops/pallas/group_norm.py::group_norm_act``'s
signature and layout (x ``[B, H, W, C]`` bf16, scale/bias ``[C]``) and its
one-pass statistics: per-channel fp32 sums of x and x², folded into group
mean and ``rsqrt(max(E[x²] - mean², 0) + eps)``, then into per-channel γ/β;
``y = x·γ + β``, then SiLU when ``act == "silu"``. A CPU tensor takes the
plain version; a CUDA tensor launches ``csrc/group_norm.cu`` or raises.

``plan`` picks the kernel's schedule per shape. Resident (one launch, x
read once): one thread-block cluster per (image, channel slab), its blocks
splitting the H·W rows, each holding its rows in shared memory; the blocks
fold their partial sums in rank order through distributed shared memory.
Streaming, where a slab does not fit a cluster's shared memory and on the
largest maps: a partial-sum kernel, a fold kernel and an apply kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from uce_tpu_torch.ops.kernels import count
from uce_tpu_torch.ops.kernels._build import launch_on, load_library, sm_count

SOURCE = "group_norm.cu"
ACTS = ("none", "silu")
TILE_ELEMS = 16384  # x elements per streaming statistics block (32 KB of bf16)
MAX_THREADS = 1024
# Resident schedule: threads per block, the most x bytes a block keeps in
# shared memory, the largest cluster (16 needs the non-portable size
# attribute), the most elements a TMA box takes along one dimension (the
# slab's channels, a box's rows; rows come in multiples of 8, so every box
# lands 128-byte aligned), the most row bands a block loads (one mbarrier
# each), the slab's least width in channels, a block's shared memory.
THREADS = 256
SMEM_X_MAX = 192 * 1024
MAX_CLUSTER = 16
MAX_BOX = 256
MAX_BANDS = 8
MIN_SLAB = 64
SMEM_MAX = 227 * 1024
# Maps of this many rows or more whose x exceeds this many bytes per SM
# stream (see plan).
STREAM_MIN_ROWS = 4096
STREAM_BYTES_PER_SM = 96 * 1024
SMS = 132  # an H100 SXM's SMs: the grid the resident plan tries to fill


@dataclass(frozen=True)
class Plan:
    """How the kernel covers a [B, H, W, C] map. Resident: B x (C / slab)
    clusters of ``cluster`` blocks, block rank r holding rows [r * rows,
    min((r + 1) * rows, H*W)) of its slab in bands of ``box_rows`` rows,
    each band TMA boxes of ``box_c`` channels. Streaming: B x ceil(H*W /
    rows) statistics blocks over all C channels (slab = C, cluster = 1),
    then the fold and the apply."""
    schedule: str   # "resident" or "stream"
    slab: int       # channels per cluster (a whole number of groups)
    cluster: int    # blocks per cluster
    rows: int       # rows of the map per block
    box_rows: int   # rows per TMA box (resident)
    box_c: int      # channels per TMA box (resident)
    threads: int    # threads per block (resident; the stats block's, streaming)
    smem: int       # dynamic shared memory per block, bytes
    blocks: int     # blocks of the (first) launch


def _row_lanes(c: int) -> int:
    return max(1, 256 // (c // 8))


def supported_shape(shape, groups: int, dtype) -> bool:
    """Whether the kernel takes x of this NHWC shape and dtype."""
    if len(shape) != 4 or dtype != torch.bfloat16:
        return False
    c = shape[3]
    return (c % groups == 0 and c % 8 == 0
            and c // 8 * _row_lanes(c) <= MAX_THREADS
            and shape[0] <= 65535 and min(shape) > 0)


def slab_channels(c: int, groups: int) -> int:
    """The resident schedule's slab: the narrowest whole number of groups
    that is a multiple of 8 channels, divides C and is at least MIN_SLAB
    channels wide (C if none is): 80 at C = 320, 120 at 960, 64 at 512."""
    step = math.lcm(c // groups, 8)
    for slab in range(step, c + 1, step):
        if c % slab == 0 and slab >= min(MIN_SLAB, c):
            return slab
    return c


def box_channels(slab: int) -> int:
    """Channels of one TMA box: the slab in as few boxes of at most MAX_BOX
    channels as divide it into multiples of 8."""
    for n in range(-(-slab // MAX_BOX), slab // 8 + 1):
        if slab % n == 0 and slab // n % 8 == 0:
            return slab // n
    return 8


def resident_smem(rows: int, slab: int, cluster: int, threads: int = THREADS) -> int:
    """A resident block's shared memory, as csrc/group_norm.cu lays it out:
    128 bytes of alignment slack, the x tile, the lanes' sums, the block's
    and every rank's partial sums, and gamma/beta, fp32."""
    lanes = threads // (slab // 8)
    return 128 + rows * slab * 2 + 4 * (2 * lanes * slab + (4 + 2 * cluster) * slab)


def _resident_rows(hw: int, cluster: int) -> tuple[int, int]:
    """(rows per block, rows per band of TMA boxes) for ``cluster`` blocks
    over hw rows."""
    need = -(-hw // cluster)
    bands = -(-need // MAX_BOX)
    box_rows = (-(-need // bands) + 7) // 8 * 8
    return bands * box_rows, box_rows


def plan(shape, groups: int, sms: int = SMS, smem_x_max: int = SMEM_X_MAX) -> Plan:
    """The schedule for x of NHWC ``shape`` with ``groups`` groups. Resident
    with the smallest cluster whose blocks hold their rows in ``smem_x_max``
    bytes, grown while the grid has fewer than ``sms`` blocks and each block
    keeps at least 32 rows; streaming where no cluster of 16 holds a slab,
    and on maps of STREAM_MIN_ROWS rows or more whose x exceeds
    STREAM_BYTES_PER_SM per SM (there the three streaming kernels, their
    second read of x from L2, measured faster than one resident launch)."""
    b, h, w, c = shape
    hw = h * w
    slab = slab_channels(c, groups)
    nslab = c // slab

    def fits(cluster):
        rows, box_rows = _resident_rows(hw, cluster)
        return (rows * slab * 2 <= smem_x_max and (cluster - 1) * rows < hw
                and rows // box_rows <= MAX_BANDS and THREADS >= slab // 8
                and resident_smem(rows, slab, cluster) <= SMEM_MAX)

    cluster = next((k for k in (1, 2, 4, 8, 16) if fits(k)), None)
    large = hw >= STREAM_MIN_ROWS and 2 * b * hw * c > STREAM_BYTES_PER_SM * sms
    if cluster is None or large:
        rows = max(1, TILE_ELEMS // c)
        lanes = _row_lanes(c)
        return Plan("stream", c, 1, rows, 0, 0, c // 8 * lanes, 4 * 2 * lanes * c,
                    b * -(-hw // rows))
    while (cluster < MAX_CLUSTER and b * nslab * cluster < sms
           and -(-hw // (2 * cluster)) >= 32 and fits(2 * cluster)):
        cluster *= 2
    rows, box_rows = _resident_rows(hw, cluster)
    return Plan("resident", slab, cluster, rows, box_rows, box_channels(slab),
                THREADS, resident_smem(rows, slab, cluster), b * nslab * cluster)


def group_norm_act_reference(x, scale, bias, groups: int = 32,
                             eps: float = 1e-5, act: str = "none"):
    """Plain PyTorch version of the kernel (same one-pass statistics)."""
    b, h, w, c = x.shape
    x32 = x.float()
    n = float(h * w * (c // groups))
    s1 = x32.sum((1, 2)).reshape(b, groups, c // groups).sum(-1) / n
    s2 = (x32 * x32).sum((1, 2)).reshape(b, groups, c // groups).sum(-1) / n
    return _apply_stats(x32, s1, s2, scale, bias, groups, eps, act).to(x.dtype)


def _apply_stats(x32, mean, sq_mean, scale, bias, groups, eps, act):
    """y from fp32 x and the group means of x and x² [B, groups]."""
    c = x32.shape[-1]
    inv = torch.rsqrt(torch.clamp(sq_mean - mean * mean, min=0.0) + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)            # [B, C]
    mu_c = mean.repeat_interleave(c // groups, dim=1)
    gamma = scale.float()[None] * inv_c
    beta = bias.float()[None] - mu_c * gamma
    y = x32 * gamma[:, None, None] + beta[:, None, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y


def group_norm_act_planned_reference(x, scale, bias, groups: int = 32,
                                     eps: float = 1e-5, act: str = "none",
                                     p: Plan | None = None):
    """The plain version with its sums taken in the plan's order: per block
    over its rows (resident) or row tile (streaming), then over the blocks
    in rank (tile) order, then over each group's channels in order."""
    b, h, w, c = x.shape
    p = p or plan(tuple(x.shape), groups)
    x32 = x.float().reshape(b, h * w, c)
    hw, cg_ = h * w, c // groups
    tot1 = torch.zeros(b, c)
    tot2 = torch.zeros(b, c)
    for r0 in range(0, hw, p.rows):
        part = x32[:, r0:r0 + p.rows]
        tot1 = tot1 + part.sum(1)
        tot2 = tot2 + (part * part).sum(1)
    s1 = torch.zeros(b, groups)
    s2 = torch.zeros(b, groups)
    for i in range(cg_):
        s1 = s1 + tot1[:, i::cg_]
        s2 = s2 + tot2[:, i::cg_]
    n = float(hw * cg_)
    y = _apply_stats(x32.reshape(b, h, w, c), s1 / n, s2 / n, scale, bias, groups,
                     eps, act)
    return y.to(x.dtype)


@functools.cache
def _lib():
    lib = load_library("group_norm", (SOURCE,))
    resident = lib.group_norm_act_resident
    resident.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    resident.restype = ctypes.c_int
    stream = lib.group_norm_act_stream
    stream.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    stream.restype = ctypes.c_int
    return resident, stream


@functools.cache
def _plan_cached(shape, groups: int, sms: int) -> Plan:
    return plan(shape, groups, sms)


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32, eps: float = 1e-5,
                   act: str = "none") -> torch.Tensor:
    """x [B, H, W, C] -> GroupNorm(groups, eps) (then SiLU if act='silu')."""
    if act not in ACTS:
        raise ValueError(f"group_norm_act: act must be one of {ACTS}, got {act!r}")
    if x.device.type == "cpu":
        return group_norm_act_reference(x, scale, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_act: unsupported device {x.device}")
    if not supported_shape(tuple(x.shape), groups, x.dtype):
        raise ValueError(f"group_norm_act: unsupported x {tuple(x.shape)} {x.dtype} "
                         f"with {groups} groups (bf16 NHWC, C % groups == 0, "
                         "C % 8 == 0)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_act: x must be contiguous NHWC and 16-byte "
                         "aligned")
    b, h, w, c = x.shape
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"group_norm_act: scale/bias must be [{c}]")
    hw = h * w
    p = _plan_cached(tuple(x.shape), groups, sm_count(x.device))
    y = torch.empty_like(x)
    context, stream = launch_on(x.device)
    resident, streaming = _lib()
    with context:
        if p.schedule == "resident":
            err = resident(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                           b, hw, c, groups, p.slab, p.box_c, p.cluster, p.rows,
                           p.box_rows, p.threads, float(eps), int(act == "silu"),
                           stream)
        else:
            tiles = -(-hw // p.rows)
            ws = torch.empty(b * tiles * 2 * c, device=x.device, dtype=torch.float32)
            gb = torch.empty(b * 2 * c, device=x.device, dtype=torch.float32)
            apply_blocks = max(1, min(-(-hw // _row_lanes(c)),
                                      sm_count(x.device) * 8 // b))
            err = streaming(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                            y.data_ptr(), ws.data_ptr(), gb.data_ptr(), b, hw, c,
                            groups, p.rows, _row_lanes(c), apply_blocks, float(eps),
                            int(act == "silu"), stream)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed (cudaError {err}, "
                           f"-2: tensor map) for x {tuple(x.shape)}, {p}")
    count("group_norm_act")  # one per call, whatever the schedule
    return y
