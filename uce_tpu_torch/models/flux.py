"""FLUX.1 joint transformer (FluxTransformer2DModel), the denoiser of the FLUX
path, as ``uce_tpu/models/flux.py`` computes it.

Packed 2x2 latent patches embedded to the inner width, T5 context and
pooled-CLIP / timestep (/ guidance) AdaLN conditioning, 3-axis interleaved
RoPE over (id, y, x), ``num_layers`` double-stream blocks (separate text and
image projections, joint attention with the text first, per-stream
AdaLayerNormZero), then ``num_single_layers`` single-stream blocks (fused
attention + MLP), and the AdaLayerNormContinuous head.

Params are the flat diffusers state dict (linear weights [out, in]); the
blocks run as a Python loop over their per-layer keys. The joint attention
goes through ``ops/attention.dot_product_attention``: under ``"auto"`` it is
long, mask-free self-attention, which the sd_attention kernel takes at
head dim 128 on the card. Each block's per-head q/k RMSNorm, RoPE and (in
double-stream blocks) the text/image join run in one call of
``ops/kernels/qk_norm_rope``: the hand-written kernel for bf16 activations
on the card at head dim 128, else its plain version (``_rms``,
``torch.cat``, ``apply_rope``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models.layers import linear, row_linear, timestep_embedding
from uce_tpu_torch.ops.attention import dot_product_attention
from uce_tpu_torch.ops.kernels import qk_norm_rope as qk_kernel

# diffusers' names of the attention projections of each block family
_DOUBLE_LINEARS = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                   "to_add_out", "to_out.0")
_DOUBLE_NORMS = ("norm_q", "norm_k", "norm_added_q", "norm_added_k")


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = False  # True for dev, False for schnell
    axes_dims_rope: tuple = (16, 56, 56)

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "FluxConfig":
        return cls(
            in_channels=cfg.get("in_channels", 64),
            num_layers=cfg.get("num_layers", 19),
            num_single_layers=cfg.get("num_single_layers", 38),
            attention_head_dim=cfg.get("attention_head_dim", 128),
            num_attention_heads=cfg.get("num_attention_heads", 24),
            joint_attention_dim=cfg.get("joint_attention_dim", 4096),
            pooled_projection_dim=cfg.get("pooled_projection_dim", 768),
            guidance_embeds=cfg.get("guidance_embeds", False),
            axes_dims_rope=tuple(cfg.get("axes_dims_rope", (16, 56, 56))),
        )

    def to_hf(self) -> dict:
        d = dataclasses.asdict(self)
        d["axes_dims_rope"] = list(d["axes_dims_rope"])
        return {"_class_name": "FluxTransformer2DModel", **d}

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


# black-forest-labs/FLUX.1-schnell transformer/config.json
SCHNELL_CONFIG = FluxConfig()


def _ln(x, eps: float = 1e-6):
    """LayerNorm without affine (elementwise_affine=False), in fp32."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def _rms(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def rope_freqs(ids: np.ndarray, axes_dims, theta: float = 10000.0, device="cpu"):
    """ids [S, n_axes] -> (cos, sin) [S, sum(axes_dims)] fp32 on ``device``,
    interleaved-pair convention (diffusers FluxPosEmbed); the angles are
    computed in float64 on the host. Every forward of a generation asks for
    the same tables, so they are built once per (ids, axes, theta, device)
    and reused (read only)."""
    ids = np.ascontiguousarray(ids, dtype=np.float64)
    return _rope_tables(ids.shape, ids.tobytes(), tuple(axes_dims), float(theta),
                        torch.device(device))


@functools.lru_cache(maxsize=8)
def _rope_tables(shape, data: bytes, axes_dims, theta, device):
    ids = np.frombuffer(data, dtype=np.float64).reshape(shape)
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dims):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
        angles = ids[:, axis:axis + 1] * freqs
        cos_parts.append(np.repeat(np.cos(angles), 2, axis=-1))
        sin_parts.append(np.repeat(np.sin(angles), 2, axis=-1))
    with torch.inference_mode(False):  # usable outside inference mode too
        return tuple(torch.as_tensor(np.concatenate(parts, -1), dtype=torch.float32,
                                     device=device) for parts in (cos_parts, sin_parts))


def apply_rope(x, cos, sin):
    """x [B, H, S, D]; interleaved pairs (x0, x1) -> (x0 cos - x1 sin,
    x1 cos + x0 sin), in fp32, returned in x's dtype."""
    x32 = x.float()
    xr = x32.reshape(*x.shape[:-1], -1, 2)
    x_rot = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).reshape(x32.shape)
    return (x32 * cos + x_rot * sin).to(x.dtype)


def _heads(x, dh: int):
    """[B, S, h*dh] -> [B, h, S, dh]: the heads a (possibly sharded)
    projection holds."""
    b, s, d = x.shape
    return x.reshape(b, s, d // dh, dh).transpose(1, 2)


def _unheads(x):
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _lin(p, name, x):
    return linear(x, p[name + ".weight"], p.get(name + ".bias"))


def _row_lin(p, name, x):
    return row_linear(x, p[name + ".weight"], p.get(name + ".bias"))


def _mlp_embed(p, name, v):
    return _lin(p, name + ".linear_2", F.silu(_lin(p, name + ".linear_1", v)))


def apply(params: Mapping[str, torch.Tensor], latents, t5_embeds, pooled, timestep,
          img_ids: np.ndarray, txt_ids: np.ndarray, config: FluxConfig,
          guidance=None):
    """Forward. latents [B, S_img, in_channels] packed patches; t5_embeds
    [B, S_txt, joint_attention_dim]; pooled [B, pooled_projection_dim];
    timestep [B] in [0, 1] (sigma; x1000 here, as diffusers); ids [S, 3]
    position grids. Returns the velocity [B, S_img, in_channels].

    Under tensor parallelism (``parallel/mesh.py::flux_layout``) the blocks'
    projections hold this rank's heads and MLP columns; ``to_out.0``,
    ``to_add_out``, ``net.2`` and the single blocks' ``proj_out`` reduce."""
    cfg, p = config, params
    dh = cfg.attention_head_dim
    dtype = latents.dtype

    x = _lin(p, "x_embedder", latents)
    enc = _lin(p, "context_embedder", t5_embeds)

    t_proj = timestep_embedding(torch.as_tensor(timestep).float() * 1000.0, 256).to(dtype)
    temb = _mlp_embed(p, "time_text_embed.timestep_embedder", t_proj)
    if cfg.guidance_embeds:
        g = torch.as_tensor(guidance, dtype=torch.float32, device=latents.device)
        g_proj = timestep_embedding(g * 1000.0, 256).to(dtype)
        temb = temb + _mlp_embed(p, "time_text_embed.guidance_embedder", g_proj)
    temb = temb + _mlp_embed(p, "time_text_embed.text_embedder", pooled.to(dtype))
    temb_act = F.silu(temb)

    s_txt = t5_embeds.shape[1]
    ids = np.concatenate([np.asarray(txt_ids), np.asarray(img_ids)], axis=0)
    cos, sin = rope_freqs(ids, cfg.axes_dims_rope, device=latents.device)

    def ada_chunks(name, n):
        return [c[:, None] for c in _lin(p, name, temb_act).chunk(n, dim=-1)]

    norm_rope = (qk_kernel.qk_norm_rope
                 if qk_kernel.routes_to_kernel(dtype, latents.device.type, dh)
                 else qk_kernel.qk_norm_rope_reference)

    def attention(segments, v):
        """segments: (q, k, q norm scale, k norm scale) projection outputs,
        text first; v [B, H, S, dh]."""
        q, k = norm_rope(segments, cos, sin, dh)
        return _unheads(dot_product_attention(q, k, v, scale=dh ** -0.5))

    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}."
        sh_m, sc_m, g_m, sh_f, sc_f, g_f = ada_chunks(b + "norm1.linear", 6)
        csh_m, csc_m, cg_m, csh_f, csc_f, cg_f = ada_chunks(b + "norm1_context.linear", 6)
        hx = _ln(x) * (1 + sc_m) + sh_m
        he = _ln(enc) * (1 + csc_m) + csh_m
        a = b + "attn."
        img = (_lin(p, a + "to_q", hx), _lin(p, a + "to_k", hx),
               p[a + "norm_q.weight"], p[a + "norm_k.weight"])
        txt = (_lin(p, a + "add_q_proj", he), _lin(p, a + "add_k_proj", he),
               p[a + "norm_added_q.weight"], p[a + "norm_added_k.weight"])
        # the text stream first in the joint sequence (diffusers' order)
        out = attention([txt, img], torch.cat([_heads(_lin(p, a + "add_v_proj", he), dh),
                                               _heads(_lin(p, a + "to_v", hx), dh)], dim=2))
        enc_out, x_out = out[:, :s_txt], out[:, s_txt:]
        x = x + g_m * _row_lin(p, a + "to_out.0", x_out)
        enc = enc + cg_m * _row_lin(p, a + "to_add_out", enc_out)

        hx = _ln(x) * (1 + sc_f) + sh_f
        x = x + g_f * _row_lin(p, b + "ff.net.2",
                               _gelu_tanh(_lin(p, b + "ff.net.0.proj", hx)))
        he = _ln(enc) * (1 + csc_f) + csh_f
        enc = enc + cg_f * _row_lin(p, b + "ff_context.net.2",
                                    _gelu_tanh(_lin(p, b + "ff_context.net.0.proj", he)))

    h = torch.cat([enc, x], dim=1)
    for i in range(cfg.num_single_layers):
        b = f"single_transformer_blocks.{i}."
        sh, sc, gate = ada_chunks(b + "norm.linear", 3)
        hn = _ln(h) * (1 + sc) + sh
        a = b + "attn."
        qk = (_lin(p, a + "to_q", hn), _lin(p, a + "to_k", hn), p[a + "norm_q.weight"],
              p[a + "norm_k.weight"])
        attn = attention([qk], _heads(_lin(p, a + "to_v", hn), dh))
        mlp = _gelu_tanh(_lin(p, b + "proj_mlp", hn))
        # sharded, this rank's rows of proj_out are [its heads; its MLP block]
        h = h + gate * _row_lin(p, b + "proj_out", torch.cat([attn, mlp], dim=-1))
    x = h[:, s_txt:]

    # AdaLayerNormContinuous head: chunk order (scale, shift)
    scale, shift = _lin(p, "norm_out.linear", temb_act).chunk(2, dim=-1)
    x = _ln(x) * (1 + scale[:, None]) + shift[:, None]
    return _lin(p, "proj_out", x)


def state_dict_shapes(config: FluxConfig) -> dict[str, tuple]:
    """Every key of the diffusers state dict with its shape (the contract
    of ``uce_tpu/models/flux.py::init_state_dict``)."""
    cfg = config
    D, dh = cfg.inner_dim, cfg.attention_head_dim
    shapes: dict[str, tuple] = {}

    def lin(name, cin, cout):
        shapes[name + ".weight"], shapes[name + ".bias"] = (cout, cin), (cout,)

    lin("x_embedder", cfg.in_channels, D)
    lin("context_embedder", cfg.joint_attention_dim, D)
    embedders = [("timestep_embedder", 256), ("text_embedder", cfg.pooled_projection_dim)]
    if cfg.guidance_embeds:
        embedders.append(("guidance_embedder", 256))
    for name, cin in embedders:
        lin(f"time_text_embed.{name}.linear_1", cin, D)
        lin(f"time_text_embed.{name}.linear_2", D, D)
    for i in range(cfg.num_layers):
        b = f"transformer_blocks.{i}"
        lin(b + ".norm1.linear", D, 6 * D)
        lin(b + ".norm1_context.linear", D, 6 * D)
        for k in _DOUBLE_LINEARS:
            lin(f"{b}.attn.{k}", D, D)
        for k in _DOUBLE_NORMS:
            shapes[f"{b}.attn.{k}.weight"] = (dh,)
        for ff in ("ff", "ff_context"):
            lin(f"{b}.{ff}.net.0.proj", D, 4 * D)
            lin(f"{b}.{ff}.net.2", 4 * D, D)
    for i in range(cfg.num_single_layers):
        b = f"single_transformer_blocks.{i}"
        lin(b + ".norm.linear", D, 3 * D)
        for k in ("to_q", "to_k", "to_v"):
            lin(f"{b}.attn.{k}", D, D)
        for k in ("norm_q", "norm_k"):
            shapes[f"{b}.attn.{k}.weight"] = (dh,)
        lin(b + ".proj_mlp", D, 4 * D)
        lin(b + ".proj_out", 5 * D, D)
    lin("norm_out.linear", D, 2 * D)
    lin("proj_out", D, cfg.in_channels)
    return shapes


def init_state_dict(config: FluxConfig, seed: int = 0, scale: float = 0.02,
                    device="cuda", dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Seeded random state dict in diffusers keys, drawn on ``device`` by a
    ``torch.Generator`` of that device (FLUX.1's 11.9 B parameters are
    23.7 GB in bf16; on the host in fp32 they would be 48 GB): linear
    weights N(0, scale^2), biases 0, the q/k RMS norm scales 1."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(int(seed))
    sd = {}
    for key, shape in state_dict_shapes(config).items():
        if key.endswith(".bias"):
            sd[key] = torch.zeros(shape, device=device, dtype=dtype)
        elif len(shape) == 1:
            sd[key] = torch.ones(shape, device=device, dtype=dtype)
        else:
            sd[key] = torch.randn(shape, generator=gen, device=device,
                                  dtype=dtype).mul_(scale)
    return sd
