"""Shared NN building blocks, NCHW layout, diffusers weight layouts
(conv OIHW, linear [out, in]). Norm statistics are computed in fp32.

bf16 activations (``kernel_route``) take the hand-written kernels, unless
``ops.kernels.route`` switched them off, wherever the kernel takes the
shape: every 3x3 stride-1 conv of an unquantized weight
(``ops/kernels/conv3x3.py``) and every GroupNorm, SiLU fused
(``ops/kernels/group_norm.py``). The kernels take NHWC: a CUDA tensor
launches the kernel, a CPU tensor takes its plain version. The models hold
bf16 activations in ``torch.channels_last``, so the NHWC view of an NCHW
tensor is free. fp32 activations and the other shapes take the library
calls.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from uce_tpu_torch.ops import kernels, quant
from uce_tpu_torch.ops.kernels import conv3x3 as conv_kernel
from uce_tpu_torch.ops.kernels import group_norm as gn_kernel
from uce_tpu_torch.parallel import workers

# Derived copies of parameters (packed conv weights, fp32 norm affines),
# made once per parameter tensor and dropped with it. Parameters are never
# modified in place (overlay_edits builds new tensors).
_derived = WeakTensorKeyDictionary()


def kernel_route(x, *names: str) -> bool:
    """Whether the activations ``x`` take the hand-written kernels ``names``
    (by default the conv3x3 and the group_norm_act kernel, and then, in the
    UNet and the VAE, channels_last): none switched off, and ``x`` a bf16
    map [B, C, H, W]."""
    return (kernels.on(*(names or ("conv3x3", "group_norm_act")))
            and x.dtype == torch.bfloat16 and x.ndim == 4)


def _derive(param: torch.Tensor, kind: str, fn):
    per_param = _derived.setdefault(param, {})
    if kind not in per_param:
        per_param[kind] = fn(param)
    return per_param[kind]


def _nhwc(x):
    """The NHWC view of an NCHW tensor (free for channels_last memory)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nhwc_shape(x):
    b, c, h, w = x.shape
    return b, h, w, c


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 1):
    """NCHW conv; ``weight`` is OIHW or a quantized dict (``ops/quant.py``),
    which never takes the conv3x3 kernel."""
    if quant.is_weight_only(weight):
        return quant.wconv2d(x, weight, bias, stride, padding)
    if quant.is_quantized(weight):
        return quant.qconv2d(x, weight, bias, stride, padding)
    if (kernel_route(x, "conv3x3") and stride == 1 and padding == 1
            and tuple(weight.shape[2:]) == (3, 3)):
        w = _derive(weight, "ohwi", conv_kernel.pack_weight)
        return conv_kernel.conv3x3(_nhwc(x), w, bias).permute(0, 3, 1, 2)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def linear(x, weight, bias=None):
    if quant.is_weight_only(weight):
        return quant.wlinear(x, weight, bias)
    if quant.is_quantized(weight):
        return quant.qlinear(x, weight, bias)
    return F.linear(x, weight, bias)


def row_linear(x, weight, bias=None):
    """A row-parallel projection (``parallel/mesh.py``'s row splits): inside
    a sharded call (``workers.model_parallel``) ``x`` and ``weight`` hold
    this rank's slice of the input width; the partial products are summed
    over the model group and the (replicated) bias added once, after the
    sum. W8A8 weights reduce their activation scale too (``quant.qlinear``).
    Outside a sharded call, ``linear``."""
    if workers.tp_size() == 1:
        return linear(x, weight, bias)
    if quant.is_quantized(weight):
        return quant.qlinear(x, weight, bias, reduce=workers.model_all_reduce)
    y = workers.model_all_reduce(linear(x, weight))
    return y if bias is None else y + bias


def group_norm_act(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                   act: str = "none"):
    """GroupNorm over the channel dim 1, statistics and affine in fp32,
    followed by an optional SiLU."""
    if kernel_route(x, "group_norm_act") and gn_kernel.supported_shape(
            _nhwc_shape(x), num_groups, x.dtype):
        y = gn_kernel.group_norm_act(
            _nhwc(x), _derive(scale, "fp32", torch.Tensor.float),
            _derive(bias, "fp32", torch.Tensor.float), num_groups, eps, act)
        return y.permute(0, 3, 1, 2)
    y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    y = y.to(x.dtype)
    return F.silu(y) if act == "silu" else y


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim, statistics and affine in fp32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def silu(x):
    return F.silu(x)


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0):
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding):
    timesteps [B] -> [B, dim] fp32."""
    half = dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent * -math.log(max_period) / (half - downscale_freq_shift)
    args = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
