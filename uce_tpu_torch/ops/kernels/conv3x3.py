"""3x3 stride-1 SAME convolution over NHWC bf16 maps: the hand-written Hopper
kernels and their plain PyTorch versions.

``conv3x3`` is the counterpart of ``uce_tpu/ops/pallas/conv3x3.py::conv3x3``:
x ``[B, H, W, Cin]`` bf16, weights packed ``[Cout, 3, 3, Cin]`` (diffusers'
OIHW permuted, see ``pack_weight``), optional bias ``[Cout]``, bf16 output
``[B, H, W, Cout]``; fp32 accumulation, the bias added before the one
rounding. A CPU tensor takes the plain version; a CUDA tensor launches one
of the two kernels of ``csrc/conv3x3.cu`` or raises. ``plan`` picks the
kernel by shape: Cin % 64 == 0 takes the TMA + wgmma kernel, with its K
range split across blocks (and a second kernel summing the splits) when the
output tiles do not fill the card; any other Cin (the latent convs, Cin = 4)
takes the mma.sync kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from uce_tpu_torch.ops.kernels import count
from uce_tpu_torch.ops.kernels._build import launch_on, load_library, sm_count

SOURCE = "conv3x3.cu"
# The wgmma kernel: 128 output pixels per block, K steps of one tap and 64
# channels, output-channel tiles of one of these widths.
TILE_PIXELS = 128
CHANNEL_STEP = 64
TILE_N = (64, 128, 160)
# At least this many K steps per split (each split refills the load ring).
MIN_SPLIT_STEPS = 4
# The mma.sync kernel's 128 x 128 output tile and K step of 32.
MMA_TILE, MMA_K = 128, 32

_weight_maps = WeakTensorKeyDictionary()  # packed weights -> {bn: tensor map}


class ConvPlan(NamedTuple):
    """How one conv runs: the kernel, its output tiles and its K split."""
    variant: str   # "wgmma" or "mma"
    bn: int        # output channels per tile
    nb: int        # the wgmma kernel's pixel rectangle: images x rows x columns
    th: int
    tw: int
    m_tiles: int   # pixel tiles
    n_tiles: int   # output-channel tiles
    ksteps: int    # K steps of the whole contraction
    per: int       # K steps per split
    splits: int


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> contiguous [Cout, 3, 3, Cin]."""
    return weight.permute(0, 2, 3, 1).contiguous()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def k_split(ksteps: int, splits: int) -> tuple[int, int]:
    """(K steps per split, splits) for at most ``splits`` splits of
    ``ksteps`` steps, none of them empty."""
    per = _cdiv(ksteps, max(1, min(splits, ksteps)))
    return per, _cdiv(ksteps, per)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, cin: int, cout: int, sms: int) -> ConvPlan:
    """The kernel and tiling for x [b, h, w, cin] -> cout on ``sms`` SMs.
    Cin % 64 == 0 takes the wgmma kernel: a rectangle of 128 pixels (up to
    64 columns wide, spanning images when one image has fewer pixels), the
    output-channel tile that pads Cout least (the wider on a tie), and as
    many K splits as fill the SMs when the output tiles alone do not, at
    least MIN_SPLIT_STEPS K steps each. Any other Cin takes the mma.sync
    kernel, unsplit."""
    if cin % CHANNEL_STEP:
        ksteps = _cdiv(9 * cin, MMA_K)
        return ConvPlan("mma", MMA_TILE, 1, 1, MMA_TILE, _cdiv(b * h * w, MMA_TILE),
                        _cdiv(cout, MMA_TILE), ksteps, ksteps, 1)
    tw = min(64, _pow2_at_least(w))
    th = min(TILE_PIXELS // tw, _pow2_at_least(h))
    nb = TILE_PIXELS // (tw * th)
    m_tiles = _cdiv(w, tw) * _cdiv(h, th) * _cdiv(b, nb)
    bn = min(TILE_N, key=lambda n: (_cdiv(cout, n) * n, -n))
    n_tiles = _cdiv(cout, bn)
    ksteps = 9 * cin // CHANNEL_STEP
    tiles = m_tiles * n_tiles
    splits = min(sms // tiles, ksteps // MIN_SPLIT_STEPS) if tiles < sms else 1
    per, splits = k_split(ksteps, max(1, splits))
    return ConvPlan("wgmma", bn, nb, th, tw, m_tiles, n_tiles, ksteps, per, splits)


def conv3x3_reference(x, w_packed, bias=None):
    """Plain PyTorch version of the kernel: the 9 taps of uce_tpu's Pallas
    kernel as fp32 matmuls over a zero-padded copy of x."""
    b, h, w, cin = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w_packed.float()
    acc = None
    for ky in range(3):
        for kx in range(3):
            part = torch.matmul(xp[:, ky:ky + h, kx:kx + w, :], wf[:, ky, kx, :].T)
            acc = part if acc is None else acc + part
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def conv3x3_partials_reference(x, w_packed, splits: int) -> torch.Tensor:
    """Plain PyTorch version of the split path's first kernel: K steps of
    one tap and 64 input channels (tap-major), ``k_split`` into at most
    ``splits`` ranges; returns each range's fp32 sum [splits, B, H, W, Cout]
    (no bias)."""
    b, h, w, cin = x.shape
    chunks = _cdiv(cin, CHANNEL_STEP)
    per, splits = k_split(9 * chunks, splits)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w_packed.float()
    parts = torch.zeros((splits, b, h, w, w_packed.shape[0]), dtype=torch.float32,
                        device=x.device)
    for z in range(splits):
        lo, hi = z * per, min(9 * chunks, (z + 1) * per)
        for tap in range(9):
            c_lo = max(lo - tap * chunks, 0) * CHANNEL_STEP
            c_hi = min(hi - tap * chunks, chunks) * CHANNEL_STEP
            if c_lo >= c_hi:
                continue
            ky, kx = divmod(tap, 3)
            parts[z] += torch.matmul(xp[:, ky:ky + h, kx:kx + w, c_lo:c_hi],
                                     wf[:, ky, kx, c_lo:c_hi].T)
    return parts


def split_reduce_reference(parts, bias=None) -> torch.Tensor:
    """Plain PyTorch version of the split-K sum: the splits added in order,
    then the bias, in fp32; one rounding to bf16."""
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(torch.bfloat16)


@functools.cache
def _lib():
    lib = load_library("conv3x3", (SOURCE,))
    lib.conv3x3_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.conv3x3_weight_map.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    lib.conv3x3_wgmma.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    lib.conv3x3_split_reduce.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.conv3x3_bf16, lib.conv3x3_weight_map, lib.conv3x3_wgmma,
               lib.conv3x3_split_reduce):
        fn.restype = ctypes.c_int
    return lib


def _weight_map(w_packed: torch.Tensor, bn: int):
    """The TMA tensor map of packed weights for ``bn``-row boxes, encoded
    once per weight tensor and box (dropped with the tensor)."""
    maps = _weight_maps.setdefault(w_packed, {})
    if bn not in maps:
        buf = ctypes.create_string_buffer(128)
        cout, cin = w_packed.shape[0], w_packed.shape[3]
        err = _lib().conv3x3_weight_map(buf, w_packed.data_ptr(), cout, cin, bn)
        if err != 0:
            raise RuntimeError(f"conv3x3: weight tensor map failed (cudaError {err})")
        maps[bn] = buf
    return maps[bn]


def conv3x3(x: torch.Tensor, w_packed: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, H, W, Cin], w_packed [Cout, 3, 3, Cin] -> [B, H, W, Cout]."""
    if x.ndim != 4 or w_packed.ndim != 4 or tuple(w_packed.shape[1:]) != (
            3, 3, x.shape[3]):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and packed weights "
                         f"{tuple(w_packed.shape)} do not match "
                         "([B,H,W,Cin], [Cout,3,3,Cin])")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w_packed, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    for name, t in (("x", x), ("weights", w_packed), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"conv3x3: {name} must be bf16 on {x.device}")
        if not t.is_contiguous() or (name != "bias" and t.data_ptr() % 16):
            raise ValueError(f"conv3x3: {name} must be contiguous (x and the "
                             "weights 16-byte aligned)")
    b, h, w, cin = x.shape
    cout = w_packed.shape[0]
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3: bias must be [{cout}]")
    if min(b, h, w, cin, cout) <= 0 or -(-cout // 128) > 65535:
        raise ValueError(f"conv3x3: unsupported shape {tuple(x.shape)} -> {cout}")
    p = plan(b, h, w, cin, cout, sm_count(x.device))
    y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    bias_ptr = bias.data_ptr() if bias is not None else None
    lib = _lib()
    context, stream = launch_on(x.device)
    if p.variant == "mma":
        with context:
            err = lib.conv3x3_bf16(x.data_ptr(), w_packed.data_ptr(), bias_ptr,
                                   y.data_ptr(), b, h, w, cin, cout, stream)
        if err != 0:
            raise RuntimeError(f"conv3x3 mma.sync kernel launch failed (cudaError {err})")
        count("conv3x3", "conv3x3_mma")
        return y
    ws = (torch.empty((p.splits, b, h, w, cout), device=x.device, dtype=torch.float32)
          if p.splits > 1 else None)
    with context:
        err = lib.conv3x3_wgmma(x.data_ptr(), _weight_map(w_packed, p.bn), bias_ptr,
                                y.data_ptr(), ws.data_ptr() if ws is not None else None,
                                b, h, w, cin, cout, p.bn, p.nb, p.th, p.tw, p.per,
                                p.splits, stream)
        if err != 0:
            raise RuntimeError(f"conv3x3 wgmma kernel launch failed (cudaError {err})")
        count("conv3x3", "conv3x3_wgmma")
        if ws is None:
            return y
        err = lib.conv3x3_split_reduce(ws.data_ptr(), bias_ptr, y.data_ptr(),
                                       b * h * w * cout, cout, p.splits, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 split reduce launch failed (cudaError {err})")
    count("conv3x3_reduce")
    return y
