"""Shared NN building blocks, NCHW layout, diffusers weight layouts
(conv OIHW, linear [out, in]). Norm statistics are computed in fp32.

``UCE_CONV_IMPL=pallas`` and ``UCE_GN_IMPL=pallas`` (read per call, the
values uce_tpu reads) route every eligible bf16 3x3 stride-1 conv and every
``group_norm_act`` to the hand-written kernels (``ops/kernels/conv3x3.py``,
``ops/kernels/group_norm.py``), which take NHWC: a CUDA tensor launches the
kernel, a CPU tensor takes its plain version. The models hold activations
in ``torch.channels_last`` on that path, so the NHWC view of an NCHW tensor
is free. Unset, the library calls run.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from uce_tpu_torch.ops.kernels import conv3x3 as conv_kernel
from uce_tpu_torch.ops.kernels import group_norm as gn_kernel

KERNEL_IMPL = "pallas"
KERNEL_VARS = ("UCE_CONV_IMPL", "UCE_GN_IMPL")

# Derived copies of parameters (packed conv weights, fp32 norm affines),
# made once per parameter tensor and dropped with it. Parameters are never
# modified in place (overlay_edits builds new tensors).
_derived = WeakTensorKeyDictionary()


def kernel_path() -> bool:
    """Whether either kernel variable selects the hand-written kernels."""
    return any(os.environ.get(k) == KERNEL_IMPL for k in KERNEL_VARS)


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
    if (os.environ.get("UCE_CONV_IMPL") == KERNEL_IMPL
            and x.dtype == torch.bfloat16 and x.ndim == 4 and stride == 1
            and padding == 1 and tuple(weight.shape[2:]) == (3, 3)):
        w = _derive(weight, "ohwi", conv_kernel.pack_weight)
        return conv_kernel.conv3x3(_nhwc(x), w, bias).permute(0, 3, 1, 2)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)


def linear(x, weight, bias=None):
    return F.linear(x, weight, bias)


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channel dim 1, statistics and affine in fp32."""
    y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def group_norm_act(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                   act: str = "none"):
    """GroupNorm followed by an optional SiLU."""
    if (os.environ.get("UCE_GN_IMPL") == KERNEL_IMPL and x.ndim == 4
            and gn_kernel.supported_shape(tuple(_nhwc_shape(x)), num_groups,
                                          x.dtype)):
        y = gn_kernel.group_norm_act(
            _nhwc(x), _derive(scale, "fp32", torch.Tensor.float),
            _derive(bias, "fp32", torch.Tensor.float), num_groups, eps, act)
        return y.permute(0, 3, 1, 2)
    y = group_norm(x, scale, bias, num_groups, eps)
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
