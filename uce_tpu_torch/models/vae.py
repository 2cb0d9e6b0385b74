"""AutoencoderKL (SD and FLUX VAE) decoder, NCHW, over a flat diffusers state
dict (latents -> pixels; the caller divides by ``scaling_factor`` first and,
for FLUX's VAE, adds ``shift_factor``). FLUX.1's VAE has no
``post_quant_conv`` (``use_post_quant_conv: false``), so its state dict has
no such key and the decode starts at ``decoder.conv_in``. A bf16 decode
(``layers.kernel_route``) holds its activations in ``torch.channels_last``,
as the UNet does."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models import layers
from uce_tpu_torch.models.layers import conv2d, group_norm_act, linear
from uce_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0  # FLUX's VAE: 0.1159
    use_post_quant_conv: bool = True  # FLUX's VAE: False

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "VAEConfig":
        return cls(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            latent_channels=cfg.get("latent_channels", 4),
            block_out_channels=tuple(cfg["block_out_channels"]),
            layers_per_block=cfg.get("layers_per_block", 2),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.18215),
            shift_factor=cfg.get("shift_factor") or 0.0,
            use_post_quant_conv=cfg.get("use_post_quant_conv", True),
        )

    def to_hf(self) -> dict:
        d = dataclasses.asdict(self)
        d["block_out_channels"] = list(d["block_out_channels"])
        return {"_class_name": "AutoencoderKL", **d}


SD_VAE_CONFIG = VAEConfig()
# black-forest-labs/FLUX.1-schnell vae/config.json (FLUX.1-dev's is the same)
FLUX_VAE_CONFIG = VAEConfig(latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
                            use_post_quant_conv=False)


def _w(p, name):
    return p[name + ".weight"], p[name + ".bias"]


def _resnet(p, pre, x, groups):
    h = group_norm_act(x, *_w(p, pre + ".norm1"), groups, eps=1e-6, act="silu")
    h = conv2d(h, *_w(p, pre + ".conv1"))
    h = group_norm_act(h, *_w(p, pre + ".norm2"), groups, eps=1e-6, act="silu")
    h = conv2d(h, *_w(p, pre + ".conv2"))
    if pre + ".conv_shortcut.weight" in p:
        x = conv2d(x, *_w(p, pre + ".conv_shortcut"), padding=0)
    return x + h


def _attn(p, pre, x, groups):
    """Single-head VAE self-attention (q/k/v linears with bias). At 512px it
    is s=4096, d=512: on the card it runs the sd_attention kernel's D-split
    variant (uce_tpu runs JAX's TPU flash kernel there)."""
    b, c, h, w = x.shape
    y = group_norm_act(x, *_w(p, pre + ".group_norm"), groups, eps=1e-6)
    y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    q = linear(y, *_w(p, pre + ".to_q"))[:, None]
    k = linear(y, *_w(p, pre + ".to_k"))[:, None]
    v = linear(y, *_w(p, pre + ".to_v"))[:, None]
    out = dot_product_attention(q, k, v)[:, 0]
    out = linear(out, *_w(p, pre + ".to_out.0"))
    return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


def decode(params: Mapping[str, torch.Tensor], latents, config: VAEConfig):
    """latents [B, latent_channels, h, w] (already scaled) ->
    [B, 3, H, W] in [-1, 1]."""
    cfg, p = config, params
    g = cfg.norm_num_groups
    kernels = layers.kernel_route(latents)
    if kernels:
        latents = latents.contiguous(memory_format=torch.channels_last)
    x = latents
    if cfg.use_post_quant_conv:
        x = conv2d(x, *_w(p, "post_quant_conv"), padding=0)
    x = conv2d(x, *_w(p, "decoder.conv_in"))
    x = _resnet(p, "decoder.mid_block.resnets.0", x, g)
    x = _attn(p, "decoder.mid_block.attentions.0", x, g)
    x = _resnet(p, "decoder.mid_block.resnets.1", x, g)
    for bi in range(len(cfg.block_out_channels)):
        for li in range(cfg.layers_per_block + 1):
            x = _resnet(p, f"decoder.up_blocks.{bi}.resnets.{li}", x, g)
        up = f"decoder.up_blocks.{bi}.upsamplers.0.conv"
        if up + ".weight" in p:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = conv2d(x, *_w(p, up))
    x = group_norm_act(x, *_w(p, "decoder.conv_norm_out"), g, eps=1e-6, act="silu")
    x = conv2d(x, *_w(p, "decoder.conv_out"))
    return x.contiguous() if kernels else x


def init_state_dict(config: VAEConfig, rng: np.random.Generator,
                    scale: float = 0.02) -> dict[str, np.ndarray]:
    """Random flat state dict (encoder and decoder) in diffusers naming, with
    the same draws as uce_tpu's, so both packages build equal weights (a
    config without ``post_quant_conv`` leaves that key out)."""
    cfg = config
    sd: dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k=3):
        sd[name + ".weight"] = (rng.standard_normal((cout, cin, k, k)) * scale
                                ).astype(np.float32)
        sd[name + ".bias"] = np.zeros(cout, np.float32)

    def lin(name, cin, cout):
        sd[name + ".weight"] = (rng.standard_normal((cout, cin)) * scale
                                ).astype(np.float32)
        sd[name + ".bias"] = np.zeros(cout, np.float32)

    def norm(name, c):
        sd[name + ".weight"] = np.ones(c, np.float32)
        sd[name + ".bias"] = np.zeros(c, np.float32)

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, k=1)

    def attn(name, c):
        norm(name + ".group_norm", c)
        for p in ("to_q", "to_k", "to_v"):
            lin(f"{name}.{p}", c, c)
        lin(name + ".to_out.0", c, c)

    ch = cfg.block_out_channels
    lc = cfg.latent_channels

    conv("encoder.conv_in", cfg.in_channels, ch[0])
    cprev = ch[0]
    for bi, c in enumerate(ch):
        for li in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{bi}.resnets.{li}",
                   cprev if li == 0 else c, c)
        if bi < len(ch) - 1:
            conv(f"encoder.down_blocks.{bi}.downsamplers.0.conv", c, c)
        cprev = c
    resnet("encoder.mid_block.resnets.0", ch[-1], ch[-1])
    attn("encoder.mid_block.attentions.0", ch[-1])
    resnet("encoder.mid_block.resnets.1", ch[-1], ch[-1])
    norm("encoder.conv_norm_out", ch[-1])
    conv("encoder.conv_out", ch[-1], 2 * lc)
    conv("quant_conv", 2 * lc, 2 * lc, k=1)

    if cfg.use_post_quant_conv:
        conv("post_quant_conv", lc, lc, k=1)
    conv("decoder.conv_in", lc, ch[-1])
    resnet("decoder.mid_block.resnets.0", ch[-1], ch[-1])
    attn("decoder.mid_block.attentions.0", ch[-1])
    resnet("decoder.mid_block.resnets.1", ch[-1], ch[-1])
    rev = list(reversed(ch))
    cprev = rev[0]
    for bi, c in enumerate(rev):
        for li in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{bi}.resnets.{li}",
                   cprev if li == 0 else c, c)
        if bi < len(rev) - 1:
            conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", c, c)
        cprev = c
    norm("decoder.conv_norm_out", ch[0])
    conv("decoder.conv_out", ch[0], cfg.out_channels)
    return sd
