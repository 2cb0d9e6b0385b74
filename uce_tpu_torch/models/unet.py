"""SD UNet2DConditionModel (SD v1.x, v2.x and SDXL's ``text_time`` variant),
NCHW, over a flat diffusers state dict.

Params are the diffusers checkpoint's own tensors (conv OIHW, linear
[out, in]) keyed by their module paths, so HF checkpoints and UCE
safetensors overlays map 1:1. Self-attention at the long sequence lengths
(64x64 and 32x32 latents at 512px) runs the sd_attention kernel through
``ops.attention.dot_product_attention``. A bf16 forward
(``layers.kernel_route``) holds its activations in ``torch.channels_last``,
the layout of the conv3x3 and group_norm_act kernels, and returns a
contiguous NCHW tensor. Weights may be the int8 dicts of ``ops/quant.py``
(``SDPipeline.quantize_weights``); a W8A8 ``to_q`` sends its self-attention
to the int8-QK^T kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models import layers
from uce_tpu_torch.models.layers import (
    conv2d,
    group_norm_act,
    layer_norm,
    linear,
    row_linear,
    silu,
    timestep_embedding,
)
from uce_tpu_torch.ops.attention import dot_product_attention
from uce_tpu_torch.ops.quant import QKEY, WKEY, concat_weights, is_quantized
from uce_tpu_torch.parallel import workers


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
    addition_embed_type: str | None = None  # SDXL: "text_time"
    addition_time_embed_dim: int | None = None  # SDXL: 256
    projection_class_embeddings_input_dim: int | None = None  # SDXL: 2816

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "UNetConfig":
        if cfg.get("addition_embed_type") not in (None, "text_time"):
            raise NotImplementedError(
                f"UNet addition_embed_type {cfg['addition_embed_type']!r} is not "
                "ported (text_time only)")

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
            addition_embed_type=cfg.get("addition_embed_type"),
            addition_time_embed_dim=cfg.get("addition_time_embed_dim"),
            projection_class_embeddings_input_dim=cfg.get(
                "projection_class_embeddings_input_dim"),
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
# stabilityai/stable-diffusion-2-1 unet/config.json
SD21_UNET_CONFIG = UNetConfig(
    cross_attention_dim=1024,
    attention_head_dim=(5, 10, 20, 20),
    use_linear_projection=True,
)
# stabilityai/stable-diffusion-xl-base-1.0 unet/config.json
SDXL_UNET_CONFIG = UNetConfig(
    block_out_channels=(320, 640, 1280),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
    cross_attention_dim=2048,
    attention_head_dim=(5, 10, 20),
    transformer_layers_per_block=(1, 2, 10),
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816,
)


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


def _attention(p, pre, x, context, heads: int):
    """diffusers Attention: to_q/to_k/to_v (no bias), to_out.0 (bias).
    Self-attention runs one fused QKV projection, cross-attention one fused
    KV projection, split in that order; a tree that mixes float and
    quantized projections (an edit overlay on a quantized UNet) runs them
    separately. A W8A8 ``to_q`` selects the int8-QK^T attention kernel.
    Under tensor parallelism the projections hold this rank's whole heads
    (``heads`` counts them all) and ``to_out.0`` is row-parallel."""
    b, tq, _ = x.shape
    wq, wk, wv = (p[f"{pre}.{n}.weight"] for n in ("to_q", "to_k", "to_v"))
    wqkv = concat_weights([wq, wk, wv]) if context is None else None
    if wqkv is not None:
        q, k, v = linear(x, wqkv).chunk(3, dim=-1)
    else:
        ctx = x if context is None else context
        q = linear(x, wq)
        wkv = concat_weights([wk, wv])
        k, v = (linear(ctx, wkv).chunk(2, dim=-1) if wkv is not None
                else (linear(ctx, wk), linear(ctx, wv)))
    dh = x.shape[-1] // heads  # SD's inner width is its query width
    local = q.shape[-1] // dh

    def split(z):
        return z.reshape(b, -1, local, dh).transpose(1, 2)

    out = dot_product_attention(split(q), split(k), split(v), qk_int8=is_quantized(wq))
    out = out.transpose(1, 2).reshape(b, tq, local * dh)
    return row_linear(out, *_w(p, pre + ".to_out.0"))


def _geglu_ff(p, pre, x):
    w, bias = _w(p, pre + ".net.0.proj")
    if bias is not None and workers.tp_size() > 1:
        # the weight holds this rank's rows of both halves [h | gate]; the
        # bias stays whole (uce_tpu replicates it): take the same rows
        half = bias.shape[0] // 2
        s, e = workers.tp_range(half)
        bias = torch.cat([bias[s:e], bias[half + s:half + e]])
    h, gate = linear(x, w, bias).chunk(2, dim=-1)
    # uce_tpu uses jax.nn.gelu's default, the tanh form (diffusers: erf)
    h = h * F.gelu(gate, approximate="tanh")
    return row_linear(h, *_w(p, pre + ".net.2"))


def _transformer_block(p, pre, x, context, heads: int):
    x = x + _attention(p, pre + ".attn1",
                       layer_norm(x, *_w(p, pre + ".norm1")), None, heads)
    x = x + _attention(p, pre + ".attn2",
                       layer_norm(x, *_w(p, pre + ".norm2")), context, heads)
    return x + _geglu_ff(p, pre + ".ff", layer_norm(x, *_w(p, pre + ".norm3")))


def _spatial_transformer(p, pre, x, context, heads: int, depth: int,
                         cfg: UNetConfig):
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
        x = _transformer_block(p, f"{pre}.transformer_blocks.{i}", x, context, heads)
    if cfg.use_linear_projection:
        x = linear(x, *_w(p, pre + ".proj_out"))
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
    else:
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        x = conv2d(x, *_w(p, pre + ".proj_out"), padding=0)
    return x + residual


def deep_feature_shape(config: UNetConfig, batch: int, latent_h: int,
                       latent_w: int, cache_level: int = 1) -> tuple:
    """NCHW shape of the DeepCache deep feature: the tensor entering up block
    ``n_blocks - cache_level`` (the output of the last skipped up block's
    upsampler). See ``apply``'s ``deep_feature`` / ``return_deep``."""
    shift = cache_level - 1
    return (batch, config.block_out_channels[cache_level], latent_h >> shift,
            latent_w >> shift)


def apply(params: Mapping[str, torch.Tensor], sample, timesteps,
          encoder_hidden_states, config: UNetConfig, *,
          added_cond: Mapping[str, torch.Tensor] | None = None,
          deep_feature: torch.Tensor | None = None, return_deep: bool = False,
          cache_level: int = 1):
    """UNet forward. sample [B, C_in, H, W], timesteps [B] or scalar,
    encoder_hidden_states [B, T, D_text] -> noise prediction [B, C_out, H, W].
    A ``text_time`` UNet (SDXL) takes ``added_cond`` = {"text_embeds": [B,
    P] pooled text, "time_ids": [B, 6]}: their embedding joins the time
    embedding.

    DeepCache (Ma et al. 2023, arXiv:2312.00858), uce_tpu's fast mode:

    * ``return_deep=True`` runs the full forward and also returns the
      feature entering up block ``n_blocks - cache_level`` -> ``(eps, deep)``;
    * a ``deep_feature`` runs only the shallow path: conv_in, down blocks
      ``< cache_level`` (for their skips), then up blocks ``>= n_blocks -
      cache_level`` from ``deep_feature``, and conv_out. The deep levels and
      the mid block are skipped.

    ``cache_level`` is the number of levels kept live (1: the full-resolution
    level only). Both paths share the skip code, so a same-step deep feature
    fed back reproduces the full forward exactly.
    """
    cfg, p = config, params
    n_blocks = len(cfg.up_block_types)
    shallow = deep_feature is not None
    if (shallow or return_deep) and not 1 <= cache_level < n_blocks:
        raise ValueError(f"cache_level must be in [1, {n_blocks - 1}]")
    if shallow and return_deep:
        raise ValueError("deep_feature and return_deep are exclusive")
    groups = cfg.norm_num_groups
    timesteps = torch.as_tensor(timesteps, device=sample.device)
    if timesteps.ndim == 0:
        timesteps = timesteps.expand(sample.shape[0])

    t_emb = timestep_embedding(
        timesteps, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
        downscale_freq_shift=cfg.freq_shift).to(sample.dtype)
    emb = linear(t_emb, *_w(p, "time_embedding.linear_1"))
    emb = linear(silu(emb), *_w(p, "time_embedding.linear_2"))
    if cfg.addition_embed_type == "text_time":
        if added_cond is None:
            raise ValueError("a text_time UNet needs added_cond "
                             "{'text_embeds', 'time_ids'}")
        time_ids = added_cond["time_ids"]
        tid = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim,
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).reshape(time_ids.shape[0], -1)
        text_embeds = added_cond["text_embeds"]
        add = torch.cat([text_embeds, tid.to(text_embeds.dtype)], dim=-1)
        add = linear(add, *_w(p, "add_embedding.linear_1"))
        add = linear(silu(add), *_w(p, "add_embedding.linear_2"))
        emb = emb + add.to(emb.dtype)
    ehs = encoder_hidden_states
    kernels = layers.kernel_route(sample)
    if kernels:
        sample = sample.contiguous(memory_format=torch.channels_last)

    x = conv2d(sample, *_w(p, "conv_in"))
    res_stack = [x]
    for bi, btype in enumerate(cfg.down_block_types):
        if shallow and bi >= cache_level:
            break
        for li in range(cfg.layers_per_block):
            x = _resnet(p, f"down_blocks.{bi}.resnets.{li}", x, emb, groups)
            if btype == "CrossAttnDownBlock2D":
                x = _spatial_transformer(
                    p, f"down_blocks.{bi}.attentions.{li}", x, ehs,
                    cfg.heads(bi), cfg.tx_layers(bi), cfg)
            res_stack.append(x)
        if f"down_blocks.{bi}.downsamplers.0.conv.weight" in p:
            # on the shallow path the last live level's downsample would
            # feed only skipped up blocks
            if shallow and bi == cache_level - 1:
                break
            x = conv2d(x, *_w(p, f"down_blocks.{bi}.downsamplers.0.conv"), stride=2)
            res_stack.append(x)

    if not shallow:
        last = len(cfg.block_out_channels) - 1
        x = _resnet(p, "mid_block.resnets.0", x, emb, groups)
        if "mid_block.attentions.0.norm.weight" in p:
            x = _spatial_transformer(p, "mid_block.attentions.0", x, ehs,
                                     cfg.heads(last), cfg.tx_layers(last), cfg)
        x = _resnet(p, "mid_block.resnets.1", x, emb, groups)

    deep_out = None
    for bi, btype in enumerate(cfg.up_block_types):
        if bi == n_blocks - cache_level:
            if return_deep:
                deep_out = x
            elif shallow:
                x = (deep_feature.contiguous(memory_format=torch.channels_last)
                     if kernels else deep_feature)
        elif shallow and bi < n_blocks - cache_level:
            continue
        rev = n_blocks - 1 - bi  # per-block head counts are indexed reversed
        for li in range(cfg.layers_per_block + 1):
            x = torch.cat([x, res_stack.pop()], dim=1)
            x = _resnet(p, f"up_blocks.{bi}.resnets.{li}", x, emb, groups)
            if btype == "CrossAttnUpBlock2D":
                x = _spatial_transformer(
                    p, f"up_blocks.{bi}.attentions.{li}", x, ehs,
                    cfg.heads(rev), cfg.tx_layers(rev), cfg)
        if f"up_blocks.{bi}.upsamplers.0.conv.weight" in p:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = conv2d(x, *_w(p, f"up_blocks.{bi}.upsamplers.0.conv"))

    x = group_norm_act(x, *_w(p, "conv_norm_out"), groups, act="silu")
    x = conv2d(x, *_w(p, "conv_out"))
    x = x.contiguous() if kernels else x
    return (x, deep_out) if return_deep else x


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def load_params(state_dict: Mapping[str, object], dtype=torch.float32,
                device="cuda") -> dict[str, torch.Tensor]:
    """Flat diffusers state dict (tensors or numpy) -> params on ``device``."""
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
            for k, v in state_dict.items()}


def overlay_edits(params: dict, edits: Mapping[str, torch.Tensor],
                  dtype=torch.bfloat16) -> dict:
    """Apply UCE safetensors edits (diffusers flat keys and layouts) onto
    params, as diffusers' load_state_dict(strict=False): unknown keys are
    skipped, a shape mismatch raises. A float edit replaces a quantized slot
    (``ops/quant.py``) outright in ``dtype``, the pipeline's dtype; the layer
    dispatch handles the mixed tree. Returns a new dict."""
    edited = dict(params)
    skipped = []
    for key, v in edits.items():
        old = edited.get(key)
        if old is None:
            skipped.append(key)
            continue
        new_dtype = dtype
        if isinstance(old, dict):  # quantized slot: check against its payload
            old = old.get(QKEY, old.get(WKEY))
        else:
            new_dtype = old.dtype
        if tuple(v.shape) != tuple(old.shape):
            raise ValueError(f"edit for '{key}' has shape {tuple(v.shape)}, "
                             f"model expects {tuple(old.shape)}")
        edited[key] = v.float().to(device=old.device, dtype=new_dtype)
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
    if cfg.addition_embed_type == "text_time":
        lin("add_embedding.linear_1", cfg.projection_class_embeddings_input_dim, ted)
        lin("add_embedding.linear_2", ted, ted)

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
