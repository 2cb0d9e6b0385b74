"""Mask-free SD attention: the hand-written Hopper kernel and its plain
PyTorch version.

``sd_attention`` computes ``softmax(q k^T * scale) v`` over ``[B, H, S, D]``
bf16 tensors, as ``uce_tpu/ops/pallas/sd_attention.py::_kernel`` does:
fp32 logits, fp32 softmax with max subtraction, P rounded to bf16, PV
accumulated in fp32. D <= 160 runs ``csrc/sd_attention.cu``: TMA loads from
a producer warp, two consumer warpgroups on wgmma with their softmax
overlapped. D = 512 (the VAE mid-block, which uce_tpu serves with JAX's
TPU flash kernel ``uce_tpu/ops/attention.py::_flash_attention``) runs
``csrc/sd_attention_d512.cu``: a wgmma kernel that may split the KV range
across blocks (``d512_splits``) and then merges the splits' partial results
in a second kernel (``merge_partials``). ``qk_int8=True`` is the W8A8
serving variant (``_kernel_qk8``): K is centred per channel and quantized
per token once here, in plain tensor ops (uce_tpu does it in XLA outside
its kernel) into rows padded to 16 bytes, and ``csrc/sd_attention_qk8.cu``
(the bf16 kernel's TMA + wgmma schedule, QK^T on int8 wgmma) quantizes q
per row and runs QK^T in int8. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uce_tpu_torch.ops.kernels import count
from uce_tpu_torch.ops.kernels._build import launch_on, load_library, sm_count

HEAD_DIMS = (40, 64, 80, 128, 160, 512)
QK8_HEAD_DIMS = (40, 64, 80, 128, 160)
SOURCE = "sd_attention.cu"
D512_SOURCE = "sd_attention_d512.cu"
QK8_SOURCE = "sd_attention_qk8.cu"
LOG2E = 1.4426950408889634
# The d=512 kernel's block: 64 query rows, KV in tiles of 32 rows.
D512_ROWS, D512_KV_TILE = 64, 32


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


def kv_split_tiles(skv: int, splits: int) -> tuple[int, int]:
    """(KV tiles per split, splits) for at most ``splits`` splits of the
    d=512 kernel's 32-row KV tiles, none of them empty."""
    tiles = -(-skv // D512_KV_TILE)
    per = -(-tiles // max(1, min(splits, tiles)))
    return per, -(-tiles // per)


def d512_splits(bh: int, sq: int, skv: int, sms: int) -> int:
    """KV splits for the d=512 kernel: enough blocks to fill ``sms`` SMs
    (one block each) when the query tiles alone do not (2 at the VAE's one
    head and s=4096 on 132 SMs), at most one per KV tile."""
    blocks = bh * -(-sq // D512_ROWS)
    return kv_split_tiles(skv, max(1, sms // blocks))[1]


def sd_attention_partials_reference(q, k, v, scale: float, splits: int):
    """Plain PyTorch version of the d=512 kernel's split path: for each KV
    split (``kv_split_tiles``), the unnormalised fp32 O of bf16 P and the
    per-row (max in log2 units, sum of fp32 P). Returns o_part
    [splits, B, H, Sq, D] and ml [splits, B, H, Sq, 2], fp32."""
    per, splits = kv_split_tiles(k.shape[2], splits)
    step = per * D512_KV_TILE
    o_part = torch.empty((splits, *q.shape), dtype=torch.float32, device=q.device)
    ml = torch.empty((splits, *q.shape[:3], 2), dtype=torch.float32, device=q.device)
    for i in range(splits):
        ks, vs = k[:, :, i * step:(i + 1) * step], v[:, :, i * step:(i + 1) * step]
        for b in range(q.shape[0]):
            x = torch.matmul(q[b].float(), ks[b].float().transpose(-1, -2))
            x = x * (scale * LOG2E)
            m = x.amax(dim=-1)
            p = torch.exp2(x - m[..., None])
            ml[i, b, ..., 0], ml[i, b, ..., 1] = m, p.sum(dim=-1)
            o_part[i, b] = torch.matmul(p.to(v.dtype).float(), vs[b].float())
    return o_part, ml


def merge_partials_reference(o_part, ml) -> torch.Tensor:
    """Plain PyTorch version of the merge kernel: rescale each split's O by
    2^(m_i - m), sum, divide by the merged row sum -> bf16 [B, H, Sq, D]."""
    m = ml[..., 0].amax(dim=0)
    w = torch.exp2(ml[..., 0] - m)
    l_sum = (w * ml[..., 1]).sum(dim=0)
    return ((w[..., None] * o_part).sum(dim=0) / l_sum[..., None]).to(torch.bfloat16)


def k_cols(d: int) -> int:
    """Columns of the int8 K that ``quantize_k`` writes for head dim d: d
    rounded up to 16, so that each row is a whole number of 16-byte units
    (TMA's stride rule; 48 at d=40)."""
    return -(-d // 16) * 16


def quantize_k(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K [B,H,Skv,D] -> (ki int8 [B,H,Skv,k_cols(D)], ks fp32 [B,H,Skv]):
    centred per channel over the sequence (softmax cancels the per-row
    constant this adds to the logits), then symmetric per-token int8; the
    columns past D are zero."""
    kf = k.float()
    kc = kf - kf.mean(dim=2, keepdim=True)
    ks = kc.abs().amax(dim=3).clamp_min(1e-6) / 127.0
    d = k.shape[-1]
    ki = torch.zeros((*k.shape[:-1], k_cols(d)), dtype=torch.int8, device=k.device)
    ki[..., :d] = torch.round(kc / ks[..., None])
    return ki, ks


def sd_attention_qk8_reference(q, ki, ks, v, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the int8-QK^T kernel (``_kernel_qk8`` line
    by line) on ``quantize_k``'s padded K, one batch row at a time. Its QK^T
    is an fp32 product of the int-valued tensors, which is exact: |sum| <=
    127^2 * D < 2^24 for D <= 1040, with TF32 off (``full_fp32``)."""
    from uce_tpu_torch.ops.solver import full_fp32

    ki = ki[..., :q.shape[-1]]
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


@functools.cache
def _lib():
    lib = load_library("sd_attention", (SOURCE,))
    fn = lib.sd_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _lib_d512():
    lib = load_library("sd_attention_d512", (D512_SOURCE,))
    fn = lib.sd_attention_d512
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    merge = lib.sd_attention_d512_merge
    merge.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    merge.restype = ctypes.c_int
    return fn, merge


def _lib_qk8():
    lib = load_library("sd_attention_qk8", (QK8_SOURCE,))
    fn = lib.sd_attention_qk8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_contiguous(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sd_attention: {name} must be contiguous and "
                             "16-byte aligned")


def sd_attention_qk8(q, ki, ks, v, scale: float) -> torch.Tensor:
    """The int8-QK^T kernel on a pre-quantized K (``quantize_k``): q and v
    [B,H,S,D] bf16, ki int8 [B,H,Skv,k_cols(D)], ks fp32 [B,H,Skv] -> bf16."""
    if q.device.type == "cpu":
        return sd_attention_qk8_reference(q, ki, ks, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention_qk8: unsupported device {q.device}")
    b, h, sq, d = q.shape
    skv = ki.shape[2]
    want = {"ki": ((b, h, skv, k_cols(d)), torch.int8),
            "ks": ((b, h, skv), torch.float32),
            "v": ((b, h, skv, d), torch.bfloat16)}
    for name, t in (("ki", ki), ("ks", ks), ("v", v)):
        if (tuple(t.shape), t.dtype) != want[name] or t.device != q.device:
            raise ValueError(f"sd_attention_qk8: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, want {want[name]}")
    if (q.dtype != torch.bfloat16 or d not in QK8_HEAD_DIMS or b * h > 65535
            or b * h * skv >= 2 ** 31):
        raise ValueError(f"sd_attention_qk8: unsupported q {tuple(q.shape)} "
                         f"{q.dtype} (bf16, D in {QK8_HEAD_DIMS}, B*H <= 65535, "
                         "B*H*Skv < 2^31)")
    _check_contiguous(q=q, ki=ki, ks=ks, v=v)
    out = torch.empty_like(q)
    context, stream = launch_on(q.device)
    with context:
        err = _lib_qk8()(q.data_ptr(), ki.data_ptr(), ks.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b * h, sq, skv, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sd_attention_qk8 kernel launch failed "
                           f"(cudaError {err})")
    count("sd_attention_qk8")
    return out


def _launch_d512(q, k, v, scale: float, splits: int):
    """One launch of the d=512 kernel on CUDA tensors: the bf16 output for
    one split, else (o_part, ml) as sd_attention_partials_reference."""
    b, h, sq, d = q.shape
    per, splits = kv_split_tiles(k.shape[2], splits)
    out = o_part = ml = None
    if splits == 1:
        out = torch.empty_like(q)
    else:
        o_part = torch.empty((splits, b, h, sq, d), device=q.device,
                             dtype=torch.float32)
        ml = torch.empty((splits, b, h, sq, 2), device=q.device,
                         dtype=torch.float32)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib_d512()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(out),
                             ptr(o_part), ptr(ml), b * h, sq, k.shape[2], per,
                             splits, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sd_attention_d512 kernel launch failed "
                           f"(cudaError {err})")
    count("sd_attention", "sd_attention_d512")
    return out if splits == 1 else (o_part, ml)


def sd_attention_partials(q, k, v, scale: float, splits: int):
    """The d=512 kernel's split path: (o_part, ml) as
    ``sd_attention_partials_reference`` (which a CPU tensor takes) for at
    least two splits of the KV range."""
    if q.device.type == "cpu":
        return sd_attention_partials_reference(q, k, v, scale, splits)
    if q.device.type != "cuda":
        raise ValueError(f"sd_attention_partials: unsupported device {q.device}")
    if not (supported(q, k) and q.shape[-1] == 512 and tuple(v.shape) == tuple(k.shape)
            and k.dtype == v.dtype == q.dtype and k.device == v.device == q.device):
        raise ValueError(f"sd_attention_partials: unsupported q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (bf16, D = 512)")
    _check_contiguous(q=q, k=k, v=v)
    if kv_split_tiles(k.shape[2], splits)[1] < 2:
        raise ValueError(f"sd_attention_partials: {splits} splits of "
                         f"{k.shape[2]} KV rows leave one split")
    return _launch_d512(q, k, v, scale, splits)


def merge_partials(o_part: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """The merge kernel on (o_part, ml) from ``sd_attention_partials`` ->
    bf16 [B, H, Sq, D]; a CPU tensor takes ``merge_partials_reference``."""
    if o_part.device.type == "cpu":
        return merge_partials_reference(o_part, ml)
    splits, b, h, sq, d = o_part.shape
    if (o_part.device.type != "cuda" or d != 512 or o_part.dtype != torch.float32
            or ml.dtype != torch.float32 or tuple(ml.shape) != (splits, b, h, sq, 2)
            or ml.device != o_part.device):
        raise ValueError(f"merge_partials: unsupported o_part "
                         f"{tuple(o_part.shape)} {o_part.dtype} on {o_part.device}, "
                         f"ml {tuple(ml.shape)} {ml.dtype}")
    _check_contiguous(o_part=o_part, ml=ml)
    out = torch.empty((b, h, sq, d), device=o_part.device, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(o_part.device).cuda_stream
    with torch.cuda.device(o_part.device):
        err = _lib_d512()[1](o_part.data_ptr(), ml.data_ptr(), out.data_ptr(),
                             b * h * sq, splits, stream)
    if err != 0:
        raise RuntimeError(f"sd_attention_d512 merge launch failed "
                           f"(cudaError {err})")
    count("sd_attention_d512_merge")
    return out


def sd_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, qk_int8: bool = False) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D] bf16 -> [B,H,Sq,D] bf16. ``qk_int8``
    runs QK^T in int8 (the W8A8 serving variant)."""
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
    if d == 512:
        splits = d512_splits(b * h, sq, k.shape[2], sm_count(q.device))
        got = _launch_d512(q, k, v, scale, splits)
        return got if splits == 1 else merge_partials(*got)
    out = torch.empty_like(q)
    context, stream = launch_on(q.device)
    with context:
        err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b * h, sq, k.shape[2], d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"sd_attention kernel launch failed "
                           f"(cudaError {err})")
    count("sd_attention", f"sd_attention_d{d}")
    return out
