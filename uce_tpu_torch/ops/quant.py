"""Post-training int8 quantization of the diffusion compute path
(uce_tpu/ops/quant.py), in the port's layouts.

A quantized weight is a dict stored at the parameter's own key:
  * ``{"qint8": int8, "scale": fp32 [out]}`` -- W8A8: activations are
    quantized on the fly and the product runs int8 x int8 -> int32
    (``qlinear``, ``qconv2d``);
  * ``{"w8int": int8, "scale": fp32 [out]}`` -- weight-only: the int8
    weight is cast to the activation dtype and the per-output-channel scale
    is applied to the output (``wlinear``, ``wconv2d``).
Payloads keep the float weight's layout: linear ``[out, in]``, conv OIHW.

The int8 products are plain large matrix products that uce_tpu leaves to
XLA, outside any Pallas kernel; here they go to ``torch._int_mm`` on both
devices. Integer accumulation is exact, so the 3x3 conv runs as one im2col
product with K = 9*Cin (uce_tpu sums nine per-tap products: the same int32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

QKEY = "qint8"
WKEY = "w8int"


def is_quantized(w) -> bool:
    """True for W8A8 dicts (int8 x int8 products)."""
    return isinstance(w, dict) and QKEY in w


def is_weight_only(w) -> bool:
    """True for weight-only int8 dicts (float arithmetic, int8 storage)."""
    return isinstance(w, dict) and WKEY in w


def concat_weights(ws):
    """Concatenate weights along the output dim (0) for fused projections.
    Handles all-float, all-W8A8 and all-weight-only inputs (per-output-channel
    scales concatenate losslessly); returns ``None`` for mixed inputs so the
    caller runs separate projections."""
    for key in (QKEY, WKEY):
        flags = [isinstance(w, dict) and key in w for w in ws]
        if all(flags):
            return {key: torch.cat([w[key] for w in ws]),
                    "scale": torch.cat([w["scale"] for w in ws])}
        if any(flags):
            return None
    return torch.cat(ws)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 rounded as an IEEE division on every device (CUDA's divide
    by a Python number multiplies by its reciprocal, which rounds otherwise
    and would move the scales and payloads off uce_tpu's)."""
    return amax.clamp_min(1e-12) / torch.full_like(amax, 127.0)


def quantize_weight(w: torch.Tensor, weight_only: bool = False) -> dict:
    """Symmetric per-output-channel int8 quantization of a float weight whose
    dim 0 is the output channel."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=tuple(range(1, w.ndim))))
    q = torch.clamp(torch.round(w / scale.view(-1, *(1,) * (w.ndim - 1))),
                    -127, 127).to(torch.int8)
    return {WKEY if weight_only else QKEY: q, "scale": scale}


def _quant_act(x: torch.Tensor, dims, reduce=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 quantization of activations over ``dims``;
    ``reduce(amax, "max")`` first takes the absmax over the other shards of
    a sharded width."""
    x32 = x.float()
    amax = x32.abs().amax(dim=dims, keepdim=True)
    scale = _scale(amax if reduce is None else reduce(amax, "max"))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ w [N, K]^T int8 -> [M, N] int32, exact.

    On CUDA ``torch._int_mm`` takes M > 16 and K, N >= 16, multiples of 8:
    a small M is padded with zero rows (exact); other shapes raise."""
    a = a.contiguous()
    m, k = a.shape
    n = w.shape[0]
    if a.device.type == "cuda":
        if k < 16 or n < 16 or k % 8 or n % 8:
            raise ValueError(f"int8_matmul: K={k}, N={n} must be >= 16 and "
                             "multiples of 8 on CUDA")
        if m <= 16:
            a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, w.t())[:m]


def qlinear(x: torch.Tensor, qw: dict, b: torch.Tensor | None = None, reduce=None):
    """x [..., in] @ int8 weight [out, in]^T, per-token activation scales.

    ``reduce(t, op)`` makes it a row-parallel layer (``x`` and the payload
    hold this rank's slice of the input width; ``op`` "max" or "sum" over
    the model group): the per-token absmax is reduced before quantizing, so
    every rank quantizes with the whole width's scale, as the unsharded
    layer does, and the exact int32 products are summed before the one
    dequantization: the unsharded result, bit for bit."""
    xq, xs = _quant_act(x, (-1,), reduce)
    y = int8_matmul(xq.reshape(-1, xq.shape[-1]), qw[QKEY])
    if reduce is not None:
        y = reduce(y, "sum")
    y = y.reshape(*x.shape[:-1], -1).float() * (xs * qw["scale"])
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def qconv2d(x: torch.Tensor, qk: dict, b: torch.Tensor | None = None,
            stride: int = 1, padding: int = 1):
    """NCHW conv with an int8 OIHW kernel and per-image activation scales
    (they commute with the spatial sum, so the dequantization is exact given
    the quantized operands). Any memory format in; the result is the NCHW
    view of an NHWC (channels_last) tensor."""
    w = qk[QKEY]
    cout, cin, kh, kw = w.shape
    xq, xs = _quant_act(x, (1, 2, 3))                    # xs [B, 1, 1, 1]
    xq = xq.permute(0, 2, 3, 1)                          # NHWC view
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))  # 0 -> 0
    bsz, hp, wp, _ = xq.shape
    oh, ow = (hp - kh) // stride + 1, (wp - kw) // stride + 1
    cols = torch.cat([xq[:, dy:dy + (oh - 1) * stride + 1:stride,
                         dx:dx + (ow - 1) * stride + 1:stride]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    y = int8_matmul(cols.reshape(-1, kh * kw * cin),
                    w.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin))
    y = y.reshape(bsz, oh, ow, cout).float() * (xs * qk["scale"])
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype).permute(0, 3, 1, 2)


def wlinear(x: torch.Tensor, qw: dict, b: torch.Tensor | None = None):
    """x [..., in] @ weight-only int8 [out, in]^T in the activation dtype; the
    per-output-channel scale commutes with the contraction."""
    y = F.linear(x, qw[WKEY].to(x.dtype))
    y = y * qw["scale"].to(y.dtype)
    if b is not None:
        y = y + b
    return y


def wconv2d(x: torch.Tensor, qk: dict, b: torch.Tensor | None = None,
            stride: int = 1, padding: int = 1):
    """NCHW conv with a weight-only int8 OIHW kernel, in the activation dtype
    (the same output-side rescale as ``wlinear``)."""
    y = F.conv2d(x, qk[WKEY].to(x.dtype), stride=stride, padding=padding)
    y = y * qk["scale"].to(y.dtype).view(1, -1, 1, 1)
    if b is not None:
        y = y + b.view(1, -1, 1, 1)
    return y
