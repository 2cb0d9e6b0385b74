"""Attention entry point used by every model of the port.

The routing keeps uce_tpu's rule: long mask-free, non-causal
self-attention (Sq >= 1024 and Sq == Skv) on a CUDA tensor, at a shape the
kernel takes, runs the hand-written sd_attention kernel; everything else
runs the plain path, as does every call while ``ops.kernels.route``
switches the kernel off. ``qk_int8``
(set by W8A8-quantized call sites) selects the kernel's int8-QK^T variant
for the calls that route to the kernel; every other call ignores it, as
uce_tpu ignores it off its kernel.
"""

from __future__ import annotations

import torch

from uce_tpu_torch.ops.kernels import on, sd_attention as sdk


def routes_to_kernel(q_shape, k_shape, dtype, device_type: str, *,
                     masked: bool = False, causal: bool = False) -> bool:
    """The routing rule, as a function of shapes."""
    sq, skv = q_shape[-2], k_shape[-2]
    return (on("sd_attention") and device_type == "cuda" and not masked and not causal
            and sq >= 1024 and sq == skv
            and sdk.supported_shape(tuple(q_shape), tuple(k_shape), dtype))


def plain_attention(q, k, v, mask, causal: bool, scale: float):
    """q, k, v [B, H, T, Dh] -> [B, H, Tq, Dh]: logits in the input dtype,
    softmax in fp32 with max subtraction (uce_tpu's ``_xla_attention``)."""
    scale = float(torch.tensor(scale, dtype=q.dtype))  # rounded as uce_tpu does
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    min_val = torch.finfo(torch.float32).min
    if causal:
        tq, tk = q.shape[-2], k.shape[-2]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~keep, min_val)
    if mask is not None:
        logits = logits.masked_fill(~mask, min_val)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v).to(q.dtype)


def dot_product_attention(q, k, v, *, mask=None, causal: bool = False,
                          scale: float | None = None, qk_int8: bool = False):
    """Multi-head attention over [B, H, T, Dh] tensors.

    mask: optional boolean [B, 1|H, Tq, Tk], True = attend.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if routes_to_kernel(
            q.shape, k.shape, q.dtype, q.device.type,
            masked=mask is not None, causal=causal):
        return sdk.sd_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                scale, qk_int8=qk_int8)
    return plain_attention(q, k, v, mask, causal, scale)
