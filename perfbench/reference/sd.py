"""Plain float32 Stable Diffusion v1 UNet and VAE decoder.

The forward passes of diffusers' ``UNet2DConditionModel`` (SD v1.x layout:
four levels, a Transformer2DModel after each resnet of the first three
down levels, the mid block and the last three up levels, conv proj_in and
proj_out) and ``AutoencoderKL``'s decoder, written with torch.nn.functional
over flat diffusers state dicts. No kernel, no cache, no batching trick.
They run on any device, ``meta`` included (the FLOP count).

One departure from the published model, shared with the system under
test: the GEGLU feed-forward takes the tanh form of GELU (diffusers: erf).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _conv(p, name, x, stride=1, padding=1):
    return F.conv2d(x, p[name + ".weight"], p.get(name + ".bias"), stride=stride,
                    padding=padding)


def _lin(p, name, x):
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def _gn(p, name, x, groups=32, eps=1e-5):
    return F.group_norm(x, groups, p[name + ".weight"], p[name + ".bias"], eps)


def _ln(p, name, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def attention(q, k, v, scale):
    """[B, H, Sq, D] x [B, H, Skv, D] -> [B, H, Sq, D]: softmax(q k^T s) v."""
    return torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1) @ v


def timestep_embedding(t, dim, flip_sin_to_cos=True, shift=0.0, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - shift))
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _resnet(p, pre, x, temb, eps=1e-5):
    h = _conv(p, pre + ".conv1", F.silu(_gn(p, pre + ".norm1", x, eps=eps)))
    if temb is not None:
        h = h + _lin(p, pre + ".time_emb_proj", F.silu(temb))[:, :, None, None]
    h = _conv(p, pre + ".conv2", F.silu(_gn(p, pre + ".norm2", h, eps=eps)))
    if pre + ".conv_shortcut.weight" in p:
        x = _conv(p, pre + ".conv_shortcut", x, padding=0)
    return x + h


def _attn(p, pre, x, ctx, heads):
    b, s, c = x.shape
    ctx = x if ctx is None else ctx
    q, k, v = (_lin(p, f"{pre}.{n}", z) for n, z in (("to_q", x), ("to_k", ctx),
                                                     ("to_v", ctx)))
    split = lambda z: z.reshape(b, -1, heads, c // heads).transpose(1, 2)
    out = attention(split(q), split(k), split(v), (c // heads) ** -0.5)
    return _lin(p, pre + ".to_out.0", out.transpose(1, 2).reshape(b, s, c))


def _transformer(p, pre, x, ctx, heads):
    b, c, h, w = x.shape
    y = _conv(p, pre + ".proj_in", _gn(p, pre + ".norm", x, eps=1e-6), padding=0)
    y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
    t = pre + ".transformer_blocks.0"
    y = y + _attn(p, t + ".attn1", _ln(p, t + ".norm1", y), None, heads)
    y = y + _attn(p, t + ".attn2", _ln(p, t + ".norm2", y), ctx, heads)
    hid, gate = _lin(p, t + ".ff.net.0.proj", _ln(p, t + ".norm3", y)).chunk(2, dim=-1)
    y = y + _lin(p, t + ".ff.net.2", hid * F.gelu(gate, approximate="tanh"))
    y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
    return x + _conv(p, pre + ".proj_out", y, padding=0)


def unet(p, cfg, sample, t, ctx):
    """Noise prediction of an SD v1 UNet: sample [B, 4, h, w], t [B], ctx
    [B, 77, 768] -> [B, 4, h, w]. ``cfg`` is the diffusers unet config."""
    chans, heads = cfg["block_out_channels"], cfg["attention_head_dim"]
    n = len(chans)
    temb = timestep_embedding(t, chans[0], cfg.get("flip_sin_to_cos", True),
                              cfg.get("freq_shift", 0))
    temb = _lin(p, "time_embedding.linear_2",
                F.silu(_lin(p, "time_embedding.linear_1", temb)))
    x = _conv(p, "conv_in", sample)
    skips = [x]
    for bi, kind in enumerate(cfg["down_block_types"]):
        for li in range(cfg["layers_per_block"]):
            x = _resnet(p, f"down_blocks.{bi}.resnets.{li}", x, temb)
            if kind.startswith("CrossAttn"):
                x = _transformer(p, f"down_blocks.{bi}.attentions.{li}", x, ctx, heads)
            skips.append(x)
        if bi < n - 1:
            x = _conv(p, f"down_blocks.{bi}.downsamplers.0.conv", x, stride=2)
            skips.append(x)
    x = _resnet(p, "mid_block.resnets.0", x, temb)
    x = _transformer(p, "mid_block.attentions.0", x, ctx, heads)
    x = _resnet(p, "mid_block.resnets.1", x, temb)
    for bi, kind in enumerate(cfg["up_block_types"]):
        for li in range(cfg["layers_per_block"] + 1):
            x = _resnet(p, f"up_blocks.{bi}.resnets.{li}",
                        torch.cat([x, skips.pop()], dim=1), temb)
            if kind.startswith("CrossAttn"):
                x = _transformer(p, f"up_blocks.{bi}.attentions.{li}", x, ctx, heads)
        if bi < n - 1:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = _conv(p, f"up_blocks.{bi}.upsamplers.0.conv", x)
    return _conv(p, "conv_out", F.silu(_gn(p, "conv_norm_out", x)))


def unet_shapes(cfg) -> dict[str, tuple]:
    """Every tensor of the SD v1 UNet's diffusers state dict, with its shape."""
    chans, ted = cfg["block_out_channels"], cfg["block_out_channels"][0] * 4
    ctx_dim, n = cfg["cross_attention_dim"], len(cfg["block_out_channels"])
    s: dict[str, tuple] = {}

    def conv(name, cin, cout, k=3):
        s[name + ".weight"], s[name + ".bias"] = (cout, cin, k, k), (cout,)

    def lin(name, cin, cout, bias=True):
        s[name + ".weight"] = (cout, cin)
        if bias:
            s[name + ".bias"] = (cout,)

    def norm(name, c):
        s[name + ".weight"], s[name + ".bias"] = (c,), (c,)

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        lin(name + ".time_emb_proj", ted, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, k=1)

    def tx(name, c):
        norm(name + ".norm", c)
        conv(name + ".proj_in", c, c, k=1)
        conv(name + ".proj_out", c, c, k=1)
        b = name + ".transformer_blocks.0"
        for i, kv_in in ((1, c), (2, ctx_dim)):
            norm(f"{b}.norm{i}", c)
            lin(f"{b}.attn{i}.to_q", c, c, bias=False)
            lin(f"{b}.attn{i}.to_k", kv_in, c, bias=False)
            lin(f"{b}.attn{i}.to_v", kv_in, c, bias=False)
            lin(f"{b}.attn{i}.to_out.0", c, c)
        norm(b + ".norm3", c)
        lin(b + ".ff.net.0.proj", c, 8 * c)
        lin(b + ".ff.net.2", 4 * c, c)

    conv("conv_in", cfg["in_channels"], chans[0])
    lin("time_embedding.linear_1", chans[0], ted)
    lin("time_embedding.linear_2", ted, ted)
    prev = chans[0]
    for bi, kind in enumerate(cfg["down_block_types"]):
        for li in range(cfg["layers_per_block"]):
            resnet(f"down_blocks.{bi}.resnets.{li}", prev if li == 0 else chans[bi],
                   chans[bi])
            if kind.startswith("CrossAttn"):
                tx(f"down_blocks.{bi}.attentions.{li}", chans[bi])
        if bi < n - 1:
            conv(f"down_blocks.{bi}.downsamplers.0.conv", chans[bi], chans[bi])
        prev = chans[bi]
    resnet("mid_block.resnets.0", chans[-1], chans[-1])
    tx("mid_block.attentions.0", chans[-1])
    resnet("mid_block.resnets.1", chans[-1], chans[-1])
    rev = list(reversed(chans))
    for bi, kind in enumerate(cfg["up_block_types"]):
        for li in range(cfg["layers_per_block"] + 1):
            skip = rev[bi] if li < cfg["layers_per_block"] else rev[min(bi + 1, n - 1)]
            cin = rev[bi - 1] if bi > 0 and li == 0 else rev[bi]
            resnet(f"up_blocks.{bi}.resnets.{li}", cin + skip, rev[bi])
            if kind.startswith("CrossAttn"):
                tx(f"up_blocks.{bi}.attentions.{li}", rev[bi])
        if bi < n - 1:
            conv(f"up_blocks.{bi}.upsamplers.0.conv", rev[bi], rev[bi])
    norm("conv_norm_out", chans[0])
    conv("conv_out", chans[0], cfg["out_channels"])
    return s


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------

def _vae_attn(p, pre, x):
    b, c, h, w = x.shape
    y = _gn(p, pre + ".group_norm", x, eps=1e-6).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
    q, k, v = (_lin(p, f"{pre}.{n}", y) for n in ("to_q", "to_k", "to_v"))
    out = _lin(p, pre + ".to_out.0", attention(q, k, v, c ** -0.5))
    return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


def vae_decode(p, cfg, z):
    """Scaled latents [B, C, h, w] -> images [B, 3, 8h, 8w] in about [-1, 1]."""
    z = _conv(p, "post_quant_conv", z, padding=0)
    x = _conv(p, "decoder.conv_in", z)
    x = _resnet(p, "decoder.mid_block.resnets.0", x, None, eps=1e-6)
    x = _vae_attn(p, "decoder.mid_block.attentions.0", x)
    x = _resnet(p, "decoder.mid_block.resnets.1", x, None, eps=1e-6)
    n = len(cfg["block_out_channels"])
    for bi in range(n):
        for li in range(cfg["layers_per_block"] + 1):
            x = _resnet(p, f"decoder.up_blocks.{bi}.resnets.{li}", x, None, eps=1e-6)
        if bi < n - 1:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
            x = _conv(p, f"decoder.up_blocks.{bi}.upsamplers.0.conv", x)
    x = F.silu(_gn(p, "decoder.conv_norm_out", x, eps=1e-6))
    return _conv(p, "decoder.conv_out", x)


def vae_decoder_shapes(cfg) -> dict[str, tuple]:
    """The decoder's tensors (and post_quant_conv) of a diffusers
    AutoencoderKL state dict; generation never runs the encoder."""
    rev, lc = list(reversed(cfg["block_out_channels"])), cfg["latent_channels"]
    s: dict[str, tuple] = {}

    def conv(name, cin, cout, k=3):
        s[name + ".weight"], s[name + ".bias"] = (cout, cin, k, k), (cout,)

    def norm(name, c):
        s[name + ".weight"], s[name + ".bias"] = (c,), (c,)

    def resnet(name, cin, cout):
        norm(name + ".norm1", cin)
        conv(name + ".conv1", cin, cout)
        norm(name + ".norm2", cout)
        conv(name + ".conv2", cout, cout)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, k=1)

    conv("post_quant_conv", lc, lc, k=1)
    conv("decoder.conv_in", lc, rev[0])
    resnet("decoder.mid_block.resnets.0", rev[0], rev[0])
    a = "decoder.mid_block.attentions.0"
    norm(a + ".group_norm", rev[0])
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        s[f"{a}.{name}.weight"], s[f"{a}.{name}.bias"] = (rev[0], rev[0]), (rev[0],)
    resnet("decoder.mid_block.resnets.1", rev[0], rev[0])
    prev = rev[0]
    for bi, c in enumerate(rev):
        for li in range(cfg["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{bi}.resnets.{li}", prev if li == 0 else c, c)
        if bi < len(rev) - 1:
            conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", c, c)
        prev = c
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], cfg["out_channels"])
    return s
