"""FLUX's per-head QK RMSNorm and 3-axis RoPE in one pass: the hand-written
Hopper kernel and its plain PyTorch version.

``qk_norm_rope`` takes one DiT block's q and k projection outputs in up to
two row segments (a double-stream block's text, then its image; a
single-stream block's one sequence), each ``[B, S_seg, H * 128]`` bf16 with
its q and k norm scales ``[128]``, and the fp32 RoPE tables ``[S, 128]`` of
the joint sequence (``models/flux.py::rope_freqs``). It returns q and k
``[B, H, S, 128]``, RMS-normed per head, scaled and rotated, the segments
joined along S: what the joint attention reads. ``csrc/qk_norm_rope.cu``
replaces no Pallas kernel (``uce_tpu``'s FLUX leaves this work to XLA); it
does in one read and one write what the plain version does in some twenty
PyTorch launches, rounding where they round.

``routes_to_kernel`` decides from the input: bf16 activations on a CUDA
device at head dim 128 take the kernel, unless ``ops.kernels.route``
switched it off; fp32 activations and CPU tensors take the plain version.
On a CPU tensor the wrapper itself runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from uce_tpu_torch.ops.kernels import count, on
from uce_tpu_torch.ops.kernels._build import launch_on, load_library

SOURCE = "qk_norm_rope.cu"
HEAD_DIM = 128
EPS = 1e-6  # FLUX's q/k RMSNorm


def routes_to_kernel(dtype, device_type: str, head_dim: int) -> bool:
    """Whether activations of ``dtype`` on ``device_type`` with heads of
    ``head_dim`` take the kernel (unless ``ops.kernels.route`` switched it
    off)."""
    return (on("qk_norm_rope") and dtype == torch.bfloat16 and device_type == "cuda"
            and head_dim == HEAD_DIM)


def qk_norm_rope_reference(segments, cos, sin, head_dim: int = HEAD_DIM,
                           eps: float = EPS):
    """Plain PyTorch version: FLUX's ``_rms`` on each segment's heads view,
    the segments joined along S, then ``apply_rope``."""
    from uce_tpu_torch.models.flux import _heads, _rms, apply_rope

    qs = [_rms(_heads(q, head_dim), q_scale, eps) for q, _, q_scale, _ in segments]
    ks = [_rms(_heads(k, head_dim), k_scale, eps) for _, k, _, k_scale in segments]
    q = torch.cat(qs, dim=2) if len(qs) > 1 else qs[0]
    k = torch.cat(ks, dim=2) if len(ks) > 1 else ks[0]
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _check(segments, cos, sin, head_dim: int) -> tuple[int, int, int]:
    """Raise unless the kernel takes these inputs; (B, H, S)."""
    if head_dim != HEAD_DIM:
        raise ValueError(f"qk_norm_rope: head dim must be {HEAD_DIM}, got {head_dim}")
    if len(segments) not in (1, 2):
        raise ValueError(f"qk_norm_rope: 1 or 2 segments, got {len(segments)}")
    shape0 = segments[0][0].shape
    if len(shape0) != 3 or shape0[2] % HEAD_DIM or shape0[2] == 0:
        raise ValueError(f"qk_norm_rope: sources must be [B, S, H * {HEAD_DIM}], got "
                         f"{tuple(shape0)}")
    b, _, width = shape0
    if b > 65535:
        raise ValueError(f"qk_norm_rope: batch {b} over the grid's 65535")
    device = segments[0][0].device
    for q, k, q_scale, k_scale in segments:
        for src in (q, k):
            if (src.dim() != 3 or src.shape[0] != b or src.shape[2] != width
                    or src.shape != q.shape or src.shape[1] == 0):
                raise ValueError(f"qk_norm_rope: segment sources {tuple(q.shape)} and "
                                 f"{tuple(k.shape)} must both be [{b}, S, {width}]")
            if src.dtype != torch.bfloat16:
                raise ValueError(f"qk_norm_rope: sources must be bf16, got {src.dtype}")
            if not src.is_contiguous() or src.data_ptr() % 16:
                raise ValueError("qk_norm_rope: sources must be contiguous and 16-byte "
                                 "aligned")
        for scale in (q_scale, k_scale):
            if (scale.shape != (HEAD_DIM,) or scale.dtype != torch.bfloat16
                    or not scale.is_contiguous()):
                raise ValueError(f"qk_norm_rope: norm scales must be contiguous bf16 "
                                 f"[{HEAD_DIM}], got {scale.dtype} {tuple(scale.shape)}")
        if any(t.device != device for t in (q, k, q_scale, k_scale)):
            raise ValueError("qk_norm_rope: every input must be on one device")
    s = sum(q.shape[1] for q, *_ in segments)
    for table in (cos, sin):
        if (table.shape != (s, HEAD_DIM) or table.dtype != torch.float32
                or not table.is_contiguous() or table.data_ptr() % 16
                or table.device != device):
            raise ValueError(f"qk_norm_rope: cos/sin must be contiguous, aligned fp32 "
                             f"[{s}, {HEAD_DIM}] on {device}, got {table.dtype} "
                             f"{tuple(table.shape)} on {table.device}")
    return b, width // HEAD_DIM, s


@functools.cache
def _lib():
    fn = load_library("qk_norm_rope", (SOURCE,)).qk_norm_rope
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]) * 2 + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def qk_norm_rope(segments, cos, sin, head_dim: int = HEAD_DIM, eps: float = EPS):
    """segments: one or two ``(q, k, q_scale, k_scale)``, text first; q, k
    ``[B, S_seg, H * 128]`` bf16 -> (q, k) ``[B, H, sum S_seg, 128]``."""
    b, heads, s = _check(segments, cos, sin, head_dim)
    device = segments[0][0].device
    if device.type == "cpu":
        return qk_norm_rope_reference(segments, cos, sin, head_dim, eps)
    if device.type != "cuda":
        raise ValueError(f"qk_norm_rope: unsupported device {device}")
    q_out = torch.empty(b, heads, s, HEAD_DIM, device=device, dtype=torch.bfloat16)
    k_out = torch.empty_like(q_out)
    args = []
    for q, k, q_scale, k_scale in segments:
        args += [q.data_ptr(), k.data_ptr(), q_scale.data_ptr(), k_scale.data_ptr(),
                 q.shape[1]]
    if len(segments) == 1:
        args += [None] * 4 + [0]  # no second segment
    context, stream = launch_on(device)
    with context:
        err = _lib()(*args, cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
                     k_out.data_ptr(), b, heads, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"qk_norm_rope kernel launch failed (cudaError {err}) for "
                           f"{len(segments)} segments, B {b}, H {heads}, S {s}")
    count("qk_norm_rope")
    return q_out, k_out
