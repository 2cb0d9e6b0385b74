"""3x3 stride-1 SAME convolution over NHWC bf16 maps: the hand-written Hopper
kernel and its plain PyTorch version.

``conv3x3`` is the counterpart of ``uce_tpu/ops/pallas/conv3x3.py::conv3x3``:
x ``[B, H, W, Cin]`` bf16, weights packed ``[Cout, 3, 3, Cin]`` (diffusers'
OIHW permuted, see ``pack_weight``), optional bias ``[Cout]``, bf16 output
``[B, H, W, Cout]``; fp32 accumulation, the bias added before the one
rounding. A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/conv3x3.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SOURCE = "conv3x3.cu"

# Kernel launches since the last reset (a plain integer; callers reset it).
launches = 0


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> contiguous [Cout, 3, 3, Cin]."""
    return weight.permute(0, 2, 3, 1).contiguous()


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


def _lib():
    from uce_tpu_torch.ops.kernels._build import load_library

    lib = load_library("conv3x3", (SOURCE,))
    fn = lib.conv3x3_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load from the build cache) the kernel library."""
    _lib()


def conv3x3(x: torch.Tensor, w_packed: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, H, W, Cin], w_packed [Cout, 3, 3, Cin] -> [B, H, W, Cout]."""
    global launches
    if x.ndim != 4 or w_packed.ndim != 4 or tuple(w_packed.shape[1:]) != (
            3, 3, x.shape[3]):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and packed weights "
                         f"{tuple(w_packed.shape)} do not match "
                         "([B,H,W,Cin], [Cout,3,3,Cin])")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w_packed, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    tensors = [("x", x), ("weights", w_packed)] + (
        [("bias", bias)] if bias is not None else [])
    for name, t in tensors:
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
    y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w_packed.data_ptr(),
                     bias.data_ptr() if bias is not None else None, y.data_ptr(),
                     b, h, w, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed (cudaError {err})")
    launches += 1
    return y
