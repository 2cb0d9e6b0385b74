"""Plain float32 FLUX.1 DiT (diffusers' ``FluxTransformer2DModel``) and
FLUX.1-schnell's sampler, over the flat diffusers state dict.

From the published description (Black Forest Labs' FLUX.1 model card and
reference code; diffusers' ``transformer_flux.py`` names the weights): the
2x2-packed latent patches and the T5 hidden states are embedded to the
inner width; the timestep (x1000, 256 sinusoidal channels, cos first) and
the pooled CLIP vector each pass an MLP and add up to the conditioning
vector; ``num_layers`` double-stream blocks (per-stream AdaLayerNormZero
with shift, scale and gate for attention and MLP, per-stream q/k/v with
RMSNorm on q and k, one joint attention over [text; image] with 3-axis
RoPE, per-stream output projections and tanh-GELU MLPs of ratio 4), then
``num_single_layers`` single-stream blocks over [text; image] (one
modulation, attention and MLP side by side from the same input, one
output projection of both), and the AdaLayerNormContinuous head (scale
before shift) and ``proj_out``. LayerNorms have no affine and eps 1e-6.

No departure from the published model. Weights may be stored in bfloat16;
each is taken to float32 where it is used. The joint attention calls
``perfbench.reference.sd.attention`` through its module, so that the work
count (``core/work.py``) sees its shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import sd as sd_ref

EPS = 1e-6


def _lin(p, name, x):
    b = p.get(name + ".bias")
    return F.linear(x, p[name + ".weight"].float(), None if b is None else b.float())


def _ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=EPS)


def _rms(x, w):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * w.float()


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def rope(ids: torch.Tensor, axes_dims, theta: float = 10000.0):
    """ids [S, n_axes] -> (cos, sin) [S, sum(axes_dims)], each angle once per
    pair of channels; angles in float64."""
    angles = []
    for axis, dim in enumerate(axes_dims):
        freqs = theta ** -(torch.arange(0, dim, 2, dtype=torch.float64) / dim)
        angles.append(ids[:, axis:axis + 1].double() * freqs[None])
    a = torch.cat(angles, dim=-1).repeat_interleave(2, dim=-1)
    return a.cos().float(), a.sin().float()


def _rotate(x, cos, sin):
    """Pairs (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin)."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    turned = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return x * cos + turned * sin


def image_ids(h: int, w: int) -> torch.Tensor:
    """[(h/2)(w/2), 3] ids (0, row, column) of the packed patches, row-major."""
    ids = torch.zeros(h // 2, w // 2, 3, dtype=torch.float64)
    ids[..., 1] = torch.arange(h // 2, dtype=torch.float64)[:, None]
    ids[..., 2] = torch.arange(w // 2, dtype=torch.float64)[None, :]
    return ids.reshape(-1, 3)


def pack(z):
    """[B, C, h, w] -> [B, (h/2)(w/2), 4C], each patch's channels (c, dy, dx)."""
    b, c, h, w = z.shape
    return z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(
        b, (h // 2) * (w // 2), 4 * c)


def unpack(x, h: int, w: int):
    b, _, c4 = x.shape
    return x.reshape(b, h // 2, w // 2, c4 // 4, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(
        b, c4 // 4, h, w)


def dit(p, cfg, latents, t5, pooled, t, h: int, w: int):
    """Velocity [B, S_img, in_channels] of packed latents [B, S_img,
    in_channels] at sigma ``t`` [B], for a latent of h x w."""
    heads, dh = cfg["num_attention_heads"], cfg["attention_head_dim"]
    b, s_txt = t5.shape[:2]
    ids = torch.cat([torch.zeros(s_txt, 3, dtype=torch.float64), image_ids(h, w)])
    cos, sin = (c.to(latents.device) for c in rope(ids, cfg.get("axes_dims_rope",
                                                                 (16, 56, 56))))
    temb = sd_ref.timestep_embedding(t * 1000.0, 256, True, 0.0)
    temb = _lin(p, "time_text_embed.timestep_embedder.linear_2",
                F.silu(_lin(p, "time_text_embed.timestep_embedder.linear_1", temb)))
    temb = temb + _lin(p, "time_text_embed.text_embedder.linear_2",
                       F.silu(_lin(p, "time_text_embed.text_embedder.linear_1", pooled)))
    act = F.silu(temb)
    x = _lin(p, "x_embedder", latents)
    c = _lin(p, "context_embedder", t5)
    split = lambda z: z.reshape(b, -1, heads, dh).transpose(1, 2)

    def mod(name, n):
        return [m[:, None] for m in _lin(p, name, act).chunk(n, dim=-1)]

    def attend(q, k, v):
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
        out = sd_ref.attention(q, k, v, dh ** -0.5)
        return out.transpose(1, 2).reshape(b, -1, heads * dh)

    for i in range(cfg["num_layers"]):
        B = f"transformer_blocks.{i}."
        sh, sc, g, sh2, sc2, g2 = mod(B + "norm1.linear", 6)
        csh, csc, cg, csh2, csc2, cg2 = mod(B + "norm1_context.linear", 6)
        nx, nc = _ln(x) * (1 + sc) + sh, _ln(c) * (1 + csc) + csh
        A = B + "attn."
        q = _rms(split(_lin(p, A + "to_q", nx)), p[A + "norm_q.weight"])
        k = _rms(split(_lin(p, A + "to_k", nx)), p[A + "norm_k.weight"])
        cq = _rms(split(_lin(p, A + "add_q_proj", nc)), p[A + "norm_added_q.weight"])
        ck = _rms(split(_lin(p, A + "add_k_proj", nc)), p[A + "norm_added_k.weight"])
        v, cv = split(_lin(p, A + "to_v", nx)), split(_lin(p, A + "add_v_proj", nc))
        out = attend(torch.cat([cq, q], 2), torch.cat([ck, k], 2), torch.cat([cv, v], 2))
        x = x + g * _lin(p, A + "to_out.0", out[:, s_txt:])
        c = c + cg * _lin(p, A + "to_add_out", out[:, :s_txt])
        x = x + g2 * _lin(p, B + "ff.net.2",
                          _gelu(_lin(p, B + "ff.net.0.proj", _ln(x) * (1 + sc2) + sh2)))
        c = c + cg2 * _lin(p, B + "ff_context.net.2",
                           _gelu(_lin(p, B + "ff_context.net.0.proj",
                                      _ln(c) * (1 + csc2) + csh2)))
    y = torch.cat([c, x], dim=1)
    for i in range(cfg["num_single_layers"]):
        B = f"single_transformer_blocks.{i}."
        sh, sc, g = mod(B + "norm.linear", 3)
        n = _ln(y) * (1 + sc) + sh
        A = B + "attn."
        q = _rms(split(_lin(p, A + "to_q", n)), p[A + "norm_q.weight"])
        k = _rms(split(_lin(p, A + "to_k", n)), p[A + "norm_k.weight"])
        both = torch.cat([attend(q, k, split(_lin(p, A + "to_v", n))),
                          _gelu(_lin(p, B + "proj_mlp", n))], dim=-1)
        y = y + g * _lin(p, B + "proj_out", both)
    scale, shift = _lin(p, "norm_out.linear", act).chunk(2, dim=-1)
    x = _ln(y[:, s_txt:]) * (1 + scale[:, None]) + shift[:, None]
    return _lin(p, "proj_out", x)


def dit_shapes(cfg) -> dict[str, tuple]:
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    dh = cfg["attention_head_dim"]
    s: dict[str, tuple] = {}

    def lin(name, cin, cout):
        s[name + ".weight"], s[name + ".bias"] = (cout, cin), (cout,)

    lin("x_embedder", cfg["in_channels"], d)
    lin("context_embedder", cfg["joint_attention_dim"], d)
    for name, cin in (("timestep_embedder", 256), ("text_embedder", cfg["pooled_projection_dim"])):
        lin(f"time_text_embed.{name}.linear_1", cin, d)
        lin(f"time_text_embed.{name}.linear_2", d, d)
    for i in range(cfg["num_layers"]):
        B = f"transformer_blocks.{i}."
        lin(B + "norm1.linear", d, 6 * d)
        lin(B + "norm1_context.linear", d, 6 * d)
        for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                  "to_out.0", "to_add_out"):
            lin(B + "attn." + n, d, d)
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            s[f"{B}attn.{n}.weight"] = (dh,)
        for ff in ("ff", "ff_context"):
            lin(f"{B}{ff}.net.0.proj", d, 4 * d)
            lin(f"{B}{ff}.net.2", 4 * d, d)
    for i in range(cfg["num_single_layers"]):
        B = f"single_transformer_blocks.{i}."
        lin(B + "norm.linear", d, 3 * d)
        for n in ("to_q", "to_k", "to_v"):
            lin(B + "attn." + n, d, d)
        for n in ("norm_q", "norm_k"):
            s[f"{B}attn.{n}.weight"] = (dh,)
        lin(B + "proj_mlp", d, 4 * d)
        lin(B + "proj_out", 5 * d, d)
    lin("norm_out.linear", d, 2 * d)
    lin("proj_out", d, cfg["in_channels"])
    return s


def sigmas(cfg, steps: int) -> np.ndarray:
    """FlowMatchEulerDiscrete's sigmas as FluxPipeline sets them: linear from
    1 to 1/steps in float32, shifted by ``shift``, then 0."""
    if cfg.get("use_dynamic_shifting"):
        raise NotImplementedError("dynamic shifting (FLUX.1-dev) is not in the reference")
    s = np.linspace(1.0, 1.0 / steps, steps).astype(np.float32)
    shift = np.float32(cfg.get("shift", 1.0))
    return np.append(shift * s / (1 + (shift - 1) * s), np.float32(0.0))


def flow_match_euler(cfg, steps: int, model, x):
    """x <- x + (sigma_next - sigma) v for each sigma; ``model(x, t)`` is
    called at t = (1000 sigma) / 1000 in float32, the transformer's input."""
    sig = sigmas(cfg, steps)
    for i in range(steps):
        t = (sig[i] * np.float32(1000.0)) / np.float32(1000.0)
        x = x + float(sig[i + 1] - sig[i]) * model(x, float(t))
    return x
