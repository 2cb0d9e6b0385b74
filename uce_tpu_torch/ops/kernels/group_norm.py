"""GroupNorm (+SiLU) over NHWC bf16 maps: the hand-written Hopper kernel and
its plain PyTorch version.

``group_norm_act`` takes ``uce_tpu/ops/pallas/group_norm.py::group_norm_act``'s
signature and layout (x ``[B, H, W, C]`` bf16, scale/bias ``[C]``) and its
one-pass statistics: per-channel fp32 sums of x and x², folded into group
mean and ``rsqrt(max(E[x²] - mean², 0) + eps)``, then into per-channel γ/β;
``y = x·γ + β``, then SiLU when ``act == "silu"``. A CPU tensor takes the
plain version; a CUDA tensor launches ``csrc/group_norm.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "group_norm.cu"
ACTS = ("none", "silu")
TILE_ELEMS = 16384  # x elements per statistics block (32 KB of bf16)
MAX_THREADS = 1024

# Kernel launches since the last reset (a plain integer; callers reset it).
launches = 0


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


def group_norm_act_reference(x, scale, bias, groups: int = 32,
                             eps: float = 1e-5, act: str = "none"):
    """Plain PyTorch version of the kernel (same one-pass statistics)."""
    b, h, w, c = x.shape
    x32 = x.float()
    n = float(h * w * (c // groups))
    s1 = x32.sum((1, 2)).reshape(b, groups, c // groups).sum(-1) / n
    s2 = (x32 * x32).sum((1, 2)).reshape(b, groups, c // groups).sum(-1) / n
    inv = torch.rsqrt(torch.clamp(s2 - s1 * s1, min=0.0) + eps)
    inv_c = inv.repeat_interleave(c // groups, dim=1)            # [B, C]
    mu_c = s1.repeat_interleave(c // groups, dim=1)
    gamma = scale.float()[None] * inv_c
    beta = bias.float()[None] - mu_c * gamma
    y = x32 * gamma[:, None, None] + beta[:, None, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _lib():
    from uce_tpu_torch.ops.kernels._build import load_library

    lib = load_library("group_norm", (SOURCE,))
    fn = lib.group_norm_act_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load from the build cache) the kernel library."""
    _lib()


def group_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   groups: int = 32, eps: float = 1e-5,
                   act: str = "none") -> torch.Tensor:
    """x [B, H, W, C] -> GroupNorm(groups, eps) (then SiLU if act='silu')."""
    global launches
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
    rows = max(1, TILE_ELEMS // c)
    tiles = -(-hw // rows)
    y = torch.empty_like(x)
    ws = torch.empty(b * tiles * 2 * c, device=x.device, dtype=torch.float32)
    gb = torch.empty(b * 2 * c, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                     ws.data_ptr(), gb.data_ptr(), b, hw, c, groups, rows,
                     _row_lanes(c), float(eps), int(act == "silu"), stream)
    if err != 0:
        raise RuntimeError(f"group_norm_act kernel launch failed (cudaError {err})")
    launches += 1
    return y
