"""SD UNet2DConditionModel, NCHW, over a flat diffusers state dict.

Params are the diffusers checkpoint's own tensors (conv OIHW, linear
[out, in]) keyed by their module paths, so HF checkpoints and UCE
safetensors overlays map 1:1. Self-attention at the long sequence lengths
(64x64 and 32x32 latents at 512px) runs the sd_attention kernel through
``ops.attention.dot_product_attention(impl="auto")``. With ``UCE_CONV_IMPL``
or ``UCE_GN_IMPL`` set to ``pallas`` (``models/layers.py``) the forward holds
its activations in ``torch.channels_last``, the layout of the conv3x3 and
group_norm_act kernels, and returns a contiguous NCHW tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models.layers import (
    conv2d,
    group_norm_act,
    kernel_path,
    layer_norm,
    linear,
    silu,
    timestep_embedding,
)
from uce_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280, 1280)
    down_block_types: tuple = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D",
    )
    up_block_types: tuple = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # diffusers legacy: for SD UNets "attention_head_dim" is the HEAD COUNT
    attention_head_dim: int | tuple = 8
    transformer_layers_per_block: int | tuple = 1
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "UNetConfig":
        if cfg.get("addition_embed_type") is not None:
            raise NotImplementedError(
                "UNet addition_embed_type (SDXL text_time) is not ported yet")

        def tup(x):
            return tuple(x) if isinstance(x, (list, tuple)) else x

        return cls(
            in_channels=cfg.get("in_channels", 4),
            out_channels=cfg.get("out_channels", 4),
            block_out_channels=tuple(cfg["block_out_channels"]),
            down_block_types=tuple(cfg["down_block_types"]),
            up_block_types=tuple(cfg["up_block_types"]),
            layers_per_block=cfg.get("layers_per_block", 2),
            cross_attention_dim=cfg.get("cross_attention_dim", 768),
            attention_head_dim=tup(cfg.get("attention_head_dim", 8)),
            transformer_layers_per_block=tup(
                cfg.get("transformer_layers_per_block", 1)),
            use_linear_projection=cfg.get("use_linear_projection", False),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
            freq_shift=cfg.get("freq_shift", 0.0),
        )

    def to_hf(self) -> dict:
        d = dataclasses.asdict(self)
        return {"_class_name": "UNet2DConditionModel",
                **{k: list(v) if isinstance(v, tuple) else v
                   for k, v in d.items()}}

    def heads(self, block_idx: int) -> int:
        a = self.attention_head_dim
        return a[block_idx] if isinstance(a, tuple) else a

    def tx_layers(self, block_idx: int) -> int:
        t = self.transformer_layers_per_block
        return t[block_idx] if isinstance(t, tuple) else t

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD14_UNET_CONFIG = UNetConfig()


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------

def _w(p, name):
    return p[name + ".weight"], p.get(name + ".bias")


def _resnet(p, pre, x, temb, groups: int):
    h = group_norm_act(x, *_w(p, pre + ".norm1"), groups, act="silu")
    h = conv2d(h, *_w(p, pre + ".conv1"))
    t = linear(silu(temb), *_w(p, pre + ".time_emb_proj"))
    h = h + t[:, :, None, None]
    h = group_norm_act(h, *_w(p, pre + ".norm2"), groups, act="silu")
    h = conv2d(h, *_w(p, pre + ".conv2"))
    if pre + ".conv_shortcut.weight" in p:
        x = conv2d(x, *_w(p, pre + ".conv_shortcut"), padding=0)
    return x + h


def _attention(p, pre, x, context, heads: int, impl: str):
    """diffusers Attention: to_q/to_k/to_v (no bias), to_out.0 (bias).
    Self-attention runs one fused QKV projection, cross-attention one fused
    KV projection, split in that order."""
    b, tq, _ = x.shape
    if context is None:
        w = torch.cat([p[pre + ".to_q.weight"], p[pre + ".to_k.weight"],
                       p[pre + ".to_v.weight"]])
        q, k, v = linear(x, w).chunk(3, dim=-1)
    else:
        q = linear(x, p[pre + ".to_q.weight"])
        w = torch.cat([p[pre + ".to_k.weight"], p[pre + ".to_v.weight"]])
        k, v = linear(context, w).chunk(2, dim=-1)
    dh = q.shape[-1] // heads

    def split(z):
        return z.reshape(b, -1, heads, dh).transpose(1, 2)

    out = dot_product_attention(split(q), split(k), split(v), impl=impl)
    out = out.transpose(1, 2).reshape(b, tq, heads * dh)
    return linear(out, *_w(p, pre + ".to_out.0"))


def _geglu_ff(p, pre, x):
    h, gate = linear(x, *_w(p, pre + ".net.0.proj")).chunk(2, dim=-1)
    # uce_tpu uses jax.nn.gelu's default, the tanh form (diffusers: erf)
    h = h * F.gelu(gate, approximate="tanh")
    return linear(h, *_w(p, pre + ".net.2"))


def _transformer_block(p, pre, x, context, heads: int, impl: str):
    x = x + _attention(p, pre + ".attn1",
                       layer_norm(x, *_w(p, pre + ".norm1")), None, heads, impl)
    x = x + _attention(p, pre + ".attn2",
                       layer_norm(x, *_w(p, pre + ".norm2")), context, heads, impl)
    return x + _geglu_ff(p, pre + ".ff", layer_norm(x, *_w(p, pre + ".norm3")))


def _spatial_transformer(p, pre, x, context, heads: int, depth: int,
                         cfg: UNetConfig, impl: str):
    """Transformer2DModel: GN -> proj_in -> blocks -> proj_out, residual."""
    b, c, h, w = x.shape
    residual = x
    x = group_norm_act(x, *_w(p, pre + ".norm"), cfg.norm_num_groups, eps=1e-6)
    if cfg.use_linear_projection:
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = linear(x, *_w(p, pre + ".proj_in"))
    else:
        x = conv2d(x, *_w(p, pre + ".proj_in"), padding=0)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
    for i in range(depth):
        x = _transformer_block(p, f"{pre}.transformer_blocks.{i}", x, context,
                               heads, impl)
    if cfg.use_linear_projection:
        x = linear(x, *_w(p, pre + ".proj_out"))
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
    else:
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        x = conv2d(x, *_w(p, pre + ".proj_out"), padding=0)
    return x + residual


def apply(params: Mapping[str, torch.Tensor], sample, timesteps,
          encoder_hidden_states, config: UNetConfig, *, attn_impl: str = "auto"):
    """UNet forward. sample [B, C_in, H, W], timesteps [B] or scalar,
    encoder_hidden_states [B, T, D_text] -> noise prediction [B, C_out, H, W].
    ``attn_impl`` is passed to every attention call ("auto" or "plain")."""
    cfg, p = config, params
    groups = cfg.norm_num_groups
    timesteps = torch.as_tensor(timesteps, device=sample.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])

    t_emb = timestep_embedding(
        timesteps, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
        downscale_freq_shift=cfg.freq_shift).to(sample.dtype)
    emb = linear(t_emb, *_w(p, "time_embedding.linear_1"))
    emb = linear(silu(emb), *_w(p, "time_embedding.linear_2"))
    ehs = encoder_hidden_states
    kernels = kernel_path()
    if kernels:
        sample = sample.contiguous(memory_format=torch.channels_last)

    x = conv2d(sample, *_w(p, "conv_in"))
    res_stack = [x]
    for bi, btype in enumerate(cfg.down_block_types):
        for li in range(cfg.layers_per_block):
            x = _resnet(p, f"down_blocks.{bi}.resnets.{li}", x, emb, groups)
            if btype == "CrossAttnDownBlock2D":
                x = _spatial_transformer(
                    p, f"down_blocks.{bi}.attentions.{li}", x, ehs,
                    cfg.heads(bi), cfg.tx_layers(bi), cfg, attn_impl)
            res_stack.append(x)
        if f"down_blocks.{bi}.downsamplers.0.conv.weight" in p:
            x = conv2d(x, *_w(p, f"down_blocks.{bi}.downsamplers.0.conv"), stride=2)
            res_stack.append(x)

    last = len(cfg.block_out_channels) - 1
    x = _resnet(p, "mid_block.resnets.0", x, emb, groups)
    if "mid_block.attentions.0.norm.weight" in p:
        x = _spatial_transformer(p, "mid_block.attentions.0", x, ehs,
                                 cfg.heads(last), cfg.tx_layers(last), cfg,
                                 attn_impl)
    x = _resnet(p, "mid_block.resnets.1", x, emb, groups)

    n_blocks = len(cfg.up_block_types)
    for bi, btype in enumerate(cfg.up_block_types):
        rev = n_blocks - 1 - bi  # per-block head counts are indexed reversed
        for li in range(cfg.layers_per_block + 1):
            x = torch.cat([x, res_stack.pop()], dim=1)
            x = _resnet(p, f"up_blocks.{bi}.resnets.{li}", x, emb, groups)
            if btype == "CrossAttnUpBlock2D":
                x = _spatial_transformer(
                    p, f"up_blocks.{bi}.attentions.{li}", x, ehs,
                    cfg.heads(rev), cfg.tx_layers(rev), cfg, attn_impl)
        if f"up_blocks.{bi}.upsamplers.0.conv.weight" in p:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = conv2d(x, *_w(p, f"up_blocks.{bi}.upsamplers.0.conv"))

    x = group_norm_act(x, *_w(p, "conv_norm_out"), groups, act="silu")
    x = conv2d(x, *_w(p, "conv_out"))
    return x.contiguous() if kernels else x


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def load_params(state_dict: Mapping[str, object], dtype=torch.float32,
                device="cpu") -> dict[str, torch.Tensor]:
    """Flat diffusers state dict (tensors or numpy) -> params on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
            for k, v in state_dict.items()}


def overlay_edits(params: dict, edits: Mapping[str, torch.Tensor]) -> dict:
    """Apply UCE safetensors edits (diffusers flat keys and layouts) onto
    params, as diffusers' load_state_dict(strict=False): unknown keys are
    skipped, a shape mismatch raises. Returns a new dict."""
    edited = dict(params)
    skipped = []
    for key, v in edits.items():
        old = edited.get(key)
        if old is None:
            skipped.append(key)
            continue
        if tuple(v.shape) != tuple(old.shape):
            raise ValueError(f"edit for '{key}' has shape {tuple(v.shape)}, "
                             f"model expects {tuple(old.shape)}")
        edited[key] = v.float().to(device=old.device, dtype=old.dtype)
    if skipped:
        print(f"overlay_edits: skipped {len(skipped)} unknown keys "
              f"(e.g. {skipped[0]})")
    return edited


def init_state_dict(config: UNetConfig, rng: np.random.Generator,
                    scale: float = 0.02) -> dict[str, np.ndarray]:
    """Random flat state dict in diffusers naming/layout (tests, smoke runs);
    it enumerates every parameter the architecture expects."""
    cfg = config
    sd: dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k=3):
        sd[name + ".weight"] = (rng.standard_normal((cout, cin, k, k)) * scale
                                ).astype(np.float32)
        sd[name + ".bias"] = np.zeros(cout, np.float32)

    def lin(name, cin, cout, bias=True):
        sd[name + ".weight"] = (rng.standard_normal((cout, cin)) * scale
                                ).astype(np.float32)
        if bias:
            sd[name + ".bias"] = np.zeros(cout, np.float32)

    def norm(name, c):
        sd[name + ".weight"] = np.ones(c, np.float32)
        sd[name + ".bias"] = np.zeros(c, np.float32)

    ted = cfg.time_embed_dim

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        lin(name + ".time_emb_proj", ted, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, k=1)

    def tx(name, c, depth):
        norm(name + ".norm", c)
        if cfg.use_linear_projection:
            lin(name + ".proj_in", c, c)
            lin(name + ".proj_out", c, c)
        else:
            conv(name + ".proj_in", c, c, k=1)
            conv(name + ".proj_out", c, c, k=1)
        for d in range(depth):
            b = f"{name}.transformer_blocks.{d}"
            norm(b + ".norm1", c)
            lin(b + ".attn1.to_q", c, c, bias=False)
            lin(b + ".attn1.to_k", c, c, bias=False)
            lin(b + ".attn1.to_v", c, c, bias=False)
            lin(b + ".attn1.to_out.0", c, c)
            norm(b + ".norm2", c)
            lin(b + ".attn2.to_q", c, c, bias=False)
            lin(b + ".attn2.to_k", cfg.cross_attention_dim, c, bias=False)
            lin(b + ".attn2.to_v", cfg.cross_attention_dim, c, bias=False)
            lin(b + ".attn2.to_out.0", c, c)
            norm(b + ".norm3", c)
            lin(b + ".ff.net.0.proj", c, c * 8)
            lin(b + ".ff.net.2", c * 4, c)

    conv("conv_in", cfg.in_channels, cfg.block_out_channels[0])
    lin("time_embedding.linear_1", cfg.block_out_channels[0], ted)
    lin("time_embedding.linear_2", ted, ted)

    cout_prev = cfg.block_out_channels[0]
    for bi, btype in enumerate(cfg.down_block_types):
        cout = cfg.block_out_channels[bi]
        for li in range(cfg.layers_per_block):
            cin = cout_prev if li == 0 else cout
            resnet(f"down_blocks.{bi}.resnets.{li}", cin, cout)
            if btype == "CrossAttnDownBlock2D":
                tx(f"down_blocks.{bi}.attentions.{li}", cout, cfg.tx_layers(bi))
        if bi < len(cfg.down_block_types) - 1:
            conv(f"down_blocks.{bi}.downsamplers.0.conv", cout, cout)
        cout_prev = cout

    c_mid = cfg.block_out_channels[-1]
    resnet("mid_block.resnets.0", c_mid, c_mid)
    tx("mid_block.attentions.0", c_mid,
       cfg.tx_layers(len(cfg.block_out_channels) - 1))
    resnet("mid_block.resnets.1", c_mid, c_mid)

    rev_channels = list(reversed(cfg.block_out_channels))
    for bi, btype in enumerate(cfg.up_block_types):
        cout = rev_channels[bi]
        cin_block = rev_channels[min(bi + 1, len(rev_channels) - 1)]
        rev = len(cfg.up_block_types) - 1 - bi
        for li in range(cfg.layers_per_block + 1):
            res_skip = rev_channels[bi] if li < cfg.layers_per_block else cin_block
            cin = rev_channels[bi - 1] if bi > 0 and li == 0 else cout
            resnet(f"up_blocks.{bi}.resnets.{li}", cin + res_skip, cout)
            if btype == "CrossAttnUpBlock2D":
                tx(f"up_blocks.{bi}.attentions.{li}", cout, cfg.tx_layers(rev))
        if bi < len(cfg.up_block_types) - 1:
            conv(f"up_blocks.{bi}.upsamplers.0.conv", cout, cout)

    norm("conv_norm_out", cfg.block_out_channels[0])
    conv("conv_out", cfg.block_out_channels[0], cfg.out_channels)
    return sd
