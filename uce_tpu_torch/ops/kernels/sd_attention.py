"""Mask-free SD attention: the hand-written Hopper kernel and its plain
PyTorch version.

``sd_attention`` computes ``softmax(q k^T * scale) v`` over ``[B, H, S, D]``
bf16 tensors, as ``uce_tpu/ops/pallas/sd_attention.py::_kernel`` does:
fp32 logits, fp32 softmax with max subtraction, P rounded to bf16, PV
accumulated in fp32. D = 512 (the VAE mid-block, which uce_tpu serves with
JAX's TPU flash kernel ``uce_tpu/ops/attention.py::_flash_attention``) runs
the same file's D-split kernel. ``qk_int8=True`` is the W8A8 serving variant
(``_kernel_qk8``): K is centred per channel and quantized per token once
here, in plain tensor ops (uce_tpu does it in XLA outside its kernel), and
``csrc/sd_attention_qk8.cu`` quantizes q per row and runs QK^T in int8. A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (40, 64, 80, 128, 160, 512)
QK8_HEAD_DIMS = (40, 64, 80, 128, 160)
SOURCE = "sd_attention.cu"
QK8_SOURCE = "sd_attention_qk8.cu"

# Launches of the bf16 kernels since the last reset (a plain integer;
# callers reset it), the same count by head dim (callers clear it), and the
# launches of the int8-QK^T kernel, counted apart.
launches = 0
launches_by_dim: dict[int, int] = {}
launches_qk8 = 0


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


def quantize_k(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K [B,H,Skv,D] -> (ki int8 [B,H,Skv,D], ks fp32 [B,H,Skv]): centred per
    channel over the sequence (softmax cancels the per-row constant this adds
    to the logits), then symmetric per-token int8."""
    kf = k.float()
    kc = kf - kf.mean(dim=2, keepdim=True)
    ks = kc.abs().amax(dim=3).clamp_min(1e-6) / 127.0
    return torch.round(kc / ks[..., None]).to(torch.int8), ks


def sd_attention_qk8_reference(q, ki, ks, v, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the int8-QK^T kernel (``_kernel_qk8`` line
    by line), one batch row at a time. Its QK^T is an fp32 product of the
    int-valued tensors, which is exact: |sum| <= 127^2 * D < 2^24 for
    D <= 1040, with TF32 off (``full_fp32``)."""
    from uce_tpu_torch.ops.solver import full_fp32

    out = torch.empty_like(q)
    for i in range(q.shape[0]):
        qf = q[i].float()
        qs = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
        qi = torch.round(qf / qs)
        with full_fp32():
            logits_i = torch.matmul(qi, ki[i].float().transpose(-1, -2))
        logits = logits_i * (qs * ks[i][:, None, :]) * scale
        p = torch.softmax(logits, dim=-1).to(v.dtype)
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


def _lib_qk8():
    from uce_tpu_torch.ops.kernels._build import load_library

    lib = load_library("sd_attention_qk8", (QK8_SOURCE,))
    fn = lib.sd_attention_qk8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load from the build cache) the bf16 kernel library."""
    _lib()


def build_qk8() -> None:
    """Compile (or load from the build cache) the int8-QK^T kernel library."""
    _lib_qk8()


def _check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sd_attention: {name} must be contiguous and "
                             "16-byte aligned")


def sd_attention_qk8(q, ki, ks, v, scale: float) -> torch.Tensor:
    """The int8-QK^T kernel on a pre-quantized K (``quantize_k``): q and v
    [B,H,S,D] bf16, ki int8 [B,H,Skv,D], ks fp32 [B,H,Skv] -> bf16."""
    global launches_qk8
    if q.device.type == "cpu":
        return sd_attention_qk8_reference(q, ki, ks, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention_qk8: unsupported device {q.device}")
    b, h, sq, d = q.shape
    skv = ki.shape[2]
    want = {"ki": ((b, h, skv, d), torch.int8), "ks": ((b, h, skv), torch.float32),
            "v": ((b, h, skv, d), torch.bfloat16)}
    for name, t in (("ki", ki), ("ks", ks), ("v", v)):
        if (tuple(t.shape), t.dtype) != want[name] or t.device != q.device:
            raise ValueError(f"sd_attention_qk8: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, want {want[name]}")
    if q.dtype != torch.bfloat16 or d not in QK8_HEAD_DIMS or b * h > 65535:
        raise ValueError(f"sd_attention_qk8: unsupported q {tuple(q.shape)} "
                         f"{q.dtype} (bf16, D in {QK8_HEAD_DIMS}, B*H <= 65535)")
    _check_contiguous(q=q, ki=ki, ks=ks, v=v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib_qk8()(q.data_ptr(), ki.data_ptr(), ks.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b * h, sq, skv, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sd_attention_qk8 kernel launch failed "
                           f"(cudaError {err})")
    launches_qk8 += 1
    return out


def sd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, qk_int8: bool = False) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D] bf16 -> [B,H,Sq,D] bf16. ``qk_int8``
    runs QK^T in int8 (the W8A8 serving variant)."""
    global launches
    if qk_int8:
        return sd_attention_qk8(q, *quantize_k(k), v, scale)
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
    _check_contiguous(q=q, k=k, v=v)
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
