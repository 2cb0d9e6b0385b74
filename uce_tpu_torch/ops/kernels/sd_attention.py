"""Mask-free SD attention: the hand-written Hopper kernel and its plain
PyTorch version.

``sd_attention`` computes ``softmax(q k^T * scale) v`` over ``[B, H, S, D]``
bf16 tensors, as ``uce_tpu/ops/pallas/sd_attention.py::_kernel`` does:
fp32 logits, fp32 softmax with max subtraction, P rounded to bf16, PV
accumulated in fp32. D = 512 (the VAE mid-block, which uce_tpu serves with
JAX's TPU flash kernel ``uce_tpu/ops/attention.py::_flash_attention``) runs
the same file's D-split kernel. A CPU tensor takes the plain version; a CUDA
tensor launches ``csrc/sd_attention.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (40, 64, 80, 128, 160, 512)
SOURCE = "sd_attention.cu"

# Kernel launches since the last reset (a plain integer; callers reset it),
# and the same count by head dim (callers clear it).
launches = 0
launches_by_dim: dict[int, int] = {}


def supported_shape(q_shape, k_shape, dtype) -> bool:
    """Whether the kernel takes q [B,H,Sq,D] and k/v [B,H,Skv,D] of dtype."""
    if len(q_shape) != 4 or len(k_shape) != 4 or dtype != torch.bfloat16:
        return False
    b, h, sq, d = q_shape
    return (tuple(k_shape[:2]) == (b, h) and k_shape[3] == d
            and d in HEAD_DIMS and sq > 0 and k_shape[2] > 0
            and b * h <= 65535)


def supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    return supported_shape(tuple(q.shape), tuple(k.shape), q.dtype)


def sd_attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one batch row at a time so the
    fp32 logits stay bounded at the long sequence lengths."""
    out = torch.empty_like(q)
    for i in range(q.shape[0]):
        logits = torch.matmul(q[i].float(), k[i].float().transpose(-1, -2))
        p = torch.softmax(logits * scale, dim=-1).to(q.dtype)
        out[i] = torch.matmul(p.float(), v[i].float()).to(q.dtype)
    return out


def _lib():
    from uce_tpu_torch.ops.kernels._build import load_library

    lib = load_library("sd_attention", (SOURCE,))
    fn = lib.sd_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load from the build cache) the kernel library."""
    _lib()


def sd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D] bf16 -> [B,H,Sq,D] bf16."""
    global launches
    if q.device.type == "cpu":
        return sd_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"sd_attention: {name} must match q's device "
                             "and dtype")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"sd_attention: v {tuple(v.shape)} != k "
                         f"{tuple(k.shape)}")
    if not supported(q, k):
        raise ValueError(
            f"sd_attention: unsupported q {tuple(q.shape)} {q.dtype}, "
            f"k {tuple(k.shape)} (bf16, D in {HEAD_DIMS}, B*H <= 65535)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sd_attention: {name} must be contiguous and "
                             "16-byte aligned")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b * h, sq, k.shape[2], d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sd_attention kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    launches_by_dim[d] = launches_by_dim.get(d, 0) + 1
    return out
