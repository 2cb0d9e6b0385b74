"""Shared NN building blocks, NCHW layout, diffusers weight layouts
(conv OIHW, linear [out, in]). Norm statistics are computed in fp32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 1):
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
