"""HiDream-I1's MoE DiT (HiDreamImageTransformer2DModel), the denoiser of
the HiDream path, as ``uce_tpu/models/hidream.py`` computes it.

Packed 2x2 latent patches (pixel-major), timestep + pooled CLIP-L|CLIP-G
AdaLN conditioning, and a text pipeline of one T5 stream and one Llama-3.1
hidden-state stream per block, each entering through its own
``caption_projection.<i>.linear`` (the UCE edit targets; T5's is the
last). ``num_layers`` double-stream blocks (separate image and text
projections, joint attention, a routed MoE on the image stream, SwiGLU on
the text) then ``num_single_layers`` single-stream MoE blocks, and an
AdaLN-modulated output head.

Text plumbing: the persistent carry is ``[T5, llama[-1]]``; double block
i attends over ``[image, carry, llama[i]]`` and writes back only the
carry; single block j appends ``llama[num_layers + j]`` and drops it after
the block. RoPE ids are (0, y, x) for image patches and zeros for all
text rows (identity rotation). The MoE is dense, as in uce_tpu: every
expert runs on every token, gated by the top-k softmax scores with no
renormalization (numerically sparse dispatch; the work is not).

Params are the flat diffusers state dict (linear weights [out, in]) with
its ``<family>.<i>.block.`` prefixes; the blocks run as a Python loop.
The joint attention goes through ``ops/attention.dot_product_attention``:
under ``"auto"`` it is long, mask-free self-attention at head dim 128,
which the sd_attention kernel takes on the card.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models.flux import _heads, _ln, _row_lin, _unheads, apply_rope, rope_freqs
from uce_tpu_torch.models.layers import linear, timestep_embedding
from uce_tpu_torch.ops import quant
from uce_tpu_torch.ops.attention import dot_product_attention
from uce_tpu_torch.parallel import workers


@dataclasses.dataclass(frozen=True)
class HiDreamConfig:
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 16
    num_single_layers: int = 32
    attention_head_dim: int = 128
    num_attention_heads: int = 20
    caption_channels: tuple = (4096, 4096)  # (T5, Llama)
    text_emb_dim: int = 2048  # pooled CLIP-L (768) + CLIP-G (1280)
    num_routed_experts: int = 4
    num_activated_experts: int = 2
    axes_dims_rope: tuple = (64, 32, 32)
    llama_layers: tuple = ()
    ffn_multiple_of: int = 256  # SwiGLU hidden rounding

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "HiDreamConfig":
        return cls(
            patch_size=cfg.get("patch_size", 2),
            in_channels=cfg.get("in_channels", 16),
            # diffusers writes 'out_channels': null for "as in_channels"
            out_channels=cfg.get("out_channels") or cfg.get("in_channels") or 16,
            num_layers=cfg.get("num_layers", 16),
            num_single_layers=cfg.get("num_single_layers", 32),
            attention_head_dim=cfg.get("attention_head_dim", 128),
            num_attention_heads=cfg.get("num_attention_heads", 20),
            caption_channels=tuple(cfg.get("caption_channels", (4096, 4096))),
            text_emb_dim=cfg.get("text_emb_dim", 2048),
            num_routed_experts=cfg.get("num_routed_experts", 4),
            num_activated_experts=cfg.get("num_activated_experts", 2),
            axes_dims_rope=tuple(cfg.get("axes_dims_rope", (64, 32, 32))),
            llama_layers=tuple(cfg.get("llama_layers", ())),
            ffn_multiple_of=cfg.get("ffn_multiple_of", 256),
        )

    def to_hf(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("caption_channels", "axes_dims_rope", "llama_layers"):
            d[k] = list(d[k])
        return {"_class_name": "HiDreamImageTransformer2DModel", **d}

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_caption_projections(self) -> int:
        return self.num_layers + self.num_single_layers + 1

    def swiglu_hidden(self, base: int) -> int:
        """FeedForwardSwiGLU's hidden width: 2/3 of base, rounded up to a
        multiple of ffn_multiple_of."""
        h = int(2 * base / 3)
        m = self.ffn_multiple_of
        return m * ((h + m - 1) // m)


# HiDream-ai/HiDream-I1-Full transformer/config.json. llama_layers as
# recalled from the published file (Llama layers 0..31, then 31 sixteen
# times); only its length, num_layers + num_single_layers = 48, sets a
# shape or a cost.
I1_FULL_CONFIG = HiDreamConfig(llama_layers=tuple(range(32)) + (31,) * 16)


def _rms_full(x, scale, eps: float = 1e-5, dh: int | None = None):
    """RMSNorm over the whole projected width (before the head split), in
    fp32 with eps 1e-5 (FLUX's per-head norm uses 1e-6).

    Under tensor parallelism ``x`` holds this rank's heads (of ``dh``
    channels) of that width and ``scale`` is whole (replicated, as uce_tpu
    keeps it): the per-token sum of squares is summed over the model group
    and divided by the whole width, and this rank's slice of ``scale``
    applied."""
    x32 = x.float()
    if workers.tp_size() == 1:
        var = (x32 * x32).mean(-1, keepdim=True)
    else:
        var = workers.model_all_reduce((x32 * x32).sum(-1, keepdim=True)) / scale.shape[0]
        s, e = workers.tp_range(scale.shape[0] // dh)
        scale = scale[s * dh:e * dh]
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _lin(p, name, x):
    return linear(x, p[name + ".weight"], p.get(name + ".bias"))


def _expert_lin(p, name, x):
    """A routed expert's projection. Its int8 weight, W8A8 or weight-only,
    is cast to the activation dtype and the scale applied to the output (the
    storage-only arithmetic of uce_tpu's ``_expert_mm``): routed experts
    never take the int8 x int8 product."""
    w = p[name + ".weight"]
    if quant.is_quantized(w):
        w = {quant.WKEY: w[quant.QKEY], "scale": w["scale"]}
    return linear(x, w)


def _swiglu(p, name, x, lin=_lin, out_lin=_row_lin):
    """SwiGLU; sharded, ``w1``/``w3`` are column-parallel and ``w2``
    (``out_lin``) row-parallel."""
    return out_lin(p, name + ".w2", F.silu(lin(p, name + ".w1", x)) * lin(p, name + ".w3", x))


def moe_gate(p, name, x, num_activated: int):
    """[B, S, E] fp32 weights of the routed experts: the top-k of the gate's
    softmax scores, zero elsewhere, not renormalized."""
    logits = torch.matmul(x.float(), p[name + ".gate.weight"].float().T)
    scores = torch.softmax(logits, dim=-1)
    top_v, top_i = scores.topk(num_activated, dim=-1)
    return torch.zeros_like(scores).scatter_(-1, top_i, top_v)


def _moe(p, name, x, cfg: HiDreamConfig):
    """Dense routed MoE + shared expert: every expert on every token, its
    output weighted by the gate (zero for the experts not in the top-k). The
    shared expert's projections dispatch as any other linear; the routed
    experts' take ``_expert_lin``.

    Expert parallelism: a rank holds only its own routed experts (the gate
    runs on every rank); their fp32 sum is summed over the model group."""
    gate_w = moe_gate(p, name, x, cfg.num_activated_experts).to(x.dtype)
    routed = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_routed_experts):
        if f"{name}.experts.{e}.w1.weight" not in p:  # another rank's expert
            continue
        routed = routed + (_swiglu(p, f"{name}.experts.{e}", x, _expert_lin, _expert_lin)
                           * gate_w[..., e:e + 1]).float()
    routed = workers.model_all_reduce(routed)
    return routed.to(x.dtype) + _swiglu(p, name + ".shared_experts", x)


def _ff_i(p, name, x, cfg: HiDreamConfig):
    if cfg.num_routed_experts > 0:
        return _moe(p, name, x, cfg)
    return _swiglu(p, name, x)


def _mlp_embed(p, name, v):
    return _lin(p, name + ".linear_2", F.silu(_lin(p, name + ".linear_1", v)))


def _qkv(p, a, x, dh: int, suffix: str = ""):
    q = _rms_full(_lin(p, f"{a}to_q{suffix}", x), p[f"{a}q_rms_norm{suffix}.weight"], dh=dh)
    k = _rms_full(_lin(p, f"{a}to_k{suffix}", x), p[f"{a}k_rms_norm{suffix}.weight"], dh=dh)
    v = _lin(p, f"{a}to_v{suffix}", x)
    return _heads(q, dh), _heads(k, dh), _heads(v, dh)


def apply(params: Mapping[str, torch.Tensor], x_packed, t5_embeds, llama_embeds, pooled,
          timesteps, img_ids: np.ndarray, config: HiDreamConfig):
    """Forward.

    x_packed [B, S_img, in_channels * p^2] packed patches; t5_embeds
    [B, S_t5, caption_channels[0]]; llama_embeds [num_layers +
    num_single_layers, B, S_ll, caption_channels[1]] (already selected by
    llama_layers); pooled [B, text_emb_dim]; timesteps [B] in scheduler
    units (0..1000); img_ids [S_img, 3]. Returns the un-negated flow
    prediction [B, S_img, out_channels * p^2] (the pipeline negates it).

    Under tensor parallelism (``parallel/mesh.py::hidream_layout``) the
    attention and SwiGLU projections hold this rank's heads and columns and
    the routed experts its own experts; ``to_out``, ``to_out_t``, ``w2`` and
    the expert sum reduce over the model group.
    """
    cfg, p = config, params
    dh = cfg.attention_head_dim
    dtype = x_packed.dtype

    x = _lin(p, "x_embedder.proj", x_packed)
    t_proj = timestep_embedding(torch.as_tensor(timesteps).float(), 256).to(dtype)
    temb = _mlp_embed(p, "t_embedder.timestep_embedder", t_proj)
    temb = temb + _mlp_embed(p, "p_embedder.pooled_embedder", pooled.to(dtype))
    temb_act = F.silu(temb)

    # caption projections: llama stream i -> projection i, T5 -> the last
    n_ll = cfg.num_caption_projections - 1
    llama_proj = [F.linear(llama_embeds[i], p[f"caption_projection.{i}.linear.weight"]
                           .to(llama_embeds.dtype)).to(dtype) for i in range(n_ll)]
    t5_proj = F.linear(t5_embeds, p[f"caption_projection.{n_ll}.linear.weight"]
                       .to(t5_embeds.dtype)).to(dtype)

    s_img, s_t5, s_ll = x_packed.shape[1], t5_proj.shape[1], llama_proj[0].shape[1]
    ids = np.concatenate([np.asarray(img_ids), np.zeros((s_t5 + 2 * s_ll, 3))], axis=0)
    cos, sin = rope_freqs(ids, cfg.axes_dims_rope, device=x_packed.device)

    def ada_chunks(name, n):
        return [c[:, None] for c in _lin(p, name, temb_act).chunk(n, dim=-1)]

    def attention(q, k, v):
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return _unheads(dot_product_attention(q, k, v, scale=q.shape[-1] ** -0.5))

    carry = torch.cat([t5_proj, llama_proj[-1]], dim=1)
    s_carry = s_t5 + s_ll
    for i in range(cfg.num_layers):
        b = f"double_stream_blocks.{i}.block."
        txt = torch.cat([carry, llama_proj[i]], dim=1)
        (sh_mi, sc_mi, g_mi, sh_fi, sc_fi, g_fi,
         sh_mt, sc_mt, g_mt, sh_ft, sc_ft, g_ft) = ada_chunks(b + "adaLN_modulation.1", 12)
        ni = _ln(x) * (1 + sc_mi) + sh_mi
        nt = _ln(txt) * (1 + sc_mt) + sh_mt
        a = b + "attn1."
        qi, ki, vi = _qkv(p, a, ni, dh)
        qt, kt, vt = _qkv(p, a, nt, dh, "_t")
        # the image first in the joint sequence
        out = attention(torch.cat([qi, qt], dim=2), torch.cat([ki, kt], dim=2),
                        torch.cat([vi, vt], dim=2))
        x = x + g_mi * _row_lin(p, a + "to_out", out[:, :s_img])
        txt = txt + g_mt * _row_lin(p, a + "to_out_t", out[:, s_img:])
        ni = _ln(x) * (1 + sc_fi) + sh_fi
        nt = _ln(txt) * (1 + sc_ft) + sh_ft
        x = x + g_fi * _ff_i(p, b + "ff_i", ni, cfg)
        txt = txt + g_ft * _swiglu(p, b + "ff_t", nt)
        carry = txt[:, :s_carry]

    h = torch.cat([x, carry], dim=1)
    s_all = s_img + s_carry
    for j in range(cfg.num_single_layers):
        b = f"single_stream_blocks.{j}.block."
        hc = torch.cat([h, llama_proj[cfg.num_layers + j]], dim=1)
        sh_m, sc_m, g_m, sh_f, sc_f, g_f = ada_chunks(b + "adaLN_modulation.1", 6)
        hn = _ln(hc) * (1 + sc_m) + sh_m
        a = b + "attn1."
        hc = hc + g_m * _row_lin(p, a + "to_out", attention(*_qkv(p, a, hn, dh)))
        hn = _ln(hc) * (1 + sc_f) + sh_f
        hc = hc + g_f * _ff_i(p, b + "ff_i", hn, cfg)
        h = hc[:, :s_all]
    x = h[:, :s_img]

    # output head: AdaLN, chunk order (shift, scale), then the patch pixels
    shift, scale = _lin(p, "final_layer.adaLN_modulation.1", temb_act).chunk(2, dim=-1)
    x = _ln(x) * (1 + scale[:, None]) + shift[:, None]
    return _lin(p, "final_layer.linear", x)


def state_dict_shapes(config: HiDreamConfig) -> dict[str, tuple]:
    """Every key of the diffusers state dict with its shape (the contract of
    ``uce_tpu/models/hidream.py::init_state_dict``)."""
    cfg = config
    D = cfg.inner_dim
    shapes: dict[str, tuple] = {}

    def lin(name, cin, cout, bias=True):
        shapes[name + ".weight"] = (cout, cin)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def ffn(prefix, base):
        h = cfg.swiglu_hidden(base)
        lin(prefix + ".w1", D, h, bias=False)
        lin(prefix + ".w2", h, D, bias=False)
        lin(prefix + ".w3", D, h, bias=False)

    def moe_ffn(prefix):
        if cfg.num_routed_experts > 0:
            ffn(prefix + ".shared_experts", 2 * D)
            for e in range(cfg.num_routed_experts):
                ffn(prefix + f".experts.{e}", 4 * D)
            shapes[prefix + ".gate.weight"] = (cfg.num_routed_experts, D)
        else:
            ffn(prefix, 4 * D)

    def attn(prefix, suffixes):
        for s in suffixes:
            for k in (f"to_q{s}", f"to_k{s}", f"to_v{s}", f"to_out{s}"):
                lin(f"{prefix}.{k}", D, D)
            shapes[f"{prefix}.q_rms_norm{s}.weight"] = (D,)
            shapes[f"{prefix}.k_rms_norm{s}.weight"] = (D,)

    lin("x_embedder.proj", cfg.in_channels * cfg.patch_size ** 2, D)
    lin("t_embedder.timestep_embedder.linear_1", 256, D)
    lin("t_embedder.timestep_embedder.linear_2", D, D)
    lin("p_embedder.pooled_embedder.linear_1", cfg.text_emb_dim, D)
    lin("p_embedder.pooled_embedder.linear_2", D, D)
    n_cp = cfg.num_caption_projections
    for i in range(n_cp):
        cin = cfg.caption_channels[0] if i == n_cp - 1 else cfg.caption_channels[1]
        lin(f"caption_projection.{i}.linear", cin, D, bias=False)
    for i in range(cfg.num_layers):
        b = f"double_stream_blocks.{i}.block"
        lin(b + ".adaLN_modulation.1", D, 12 * D)
        attn(b + ".attn1", ("", "_t"))
        moe_ffn(b + ".ff_i")
        ffn(b + ".ff_t", 4 * D)
    for i in range(cfg.num_single_layers):
        b = f"single_stream_blocks.{i}.block"
        lin(b + ".adaLN_modulation.1", D, 6 * D)
        attn(b + ".attn1", ("",))
        moe_ffn(b + ".ff_i")
    lin("final_layer.linear", D, cfg.patch_size ** 2 * cfg.out_channels)
    lin("final_layer.adaLN_modulation.1", D, 2 * D)
    return shapes


def convert_key(key: str) -> str:
    """A diffusers HiDream key -> its key in ``state_dict_shapes``: blocks
    without the ``HiDreamBlock`` wrapper get their ``.block`` back, and
    ``to_out.0`` / ``to_out_t.0`` (the ModuleList form) become the bare
    Linear's keys, as uce_tpu's converter accepts both."""
    key = re.sub(r"^(double_stream_blocks|single_stream_blocks)\.(\d+)\.(?!block\.)",
                 r"\1.\2.block.", key)
    return re.sub(r"\.(to_out(?:_t)?)\.0\.", r".\1.", key)


def convert_hf_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A diffusers HiDream state dict -> params in ``state_dict_shapes``'
    keys (``convert_key``; the tensors themselves are not copied)."""
    return {convert_key(key): v for key, v in state_dict.items()}


def init_state_dict(config: HiDreamConfig, seed: int = 0, scale: float = 0.02,
                    device="cuda", dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Seeded random state dict in diffusers keys, drawn on ``device`` by a
    ``torch.Generator`` of that device (HiDream-I1's 17.1 B parameters are
    34.2 GB in bf16): linear weights and the MoE gate N(0, scale^2), biases
    0, the q/k RMS norm scales 1."""
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
