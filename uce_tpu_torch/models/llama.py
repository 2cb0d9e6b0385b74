"""Llama 3.x decoder as a text encoder (HiDream-I1's text_encoder_4:
Llama-3.1-8B-Instruct), as ``uce_tpu/models/llama.py`` computes it.

Inference only, with ``output_hidden_states`` semantics and no LM head:
fp32 RMSNorm, grouped-query attention by repeating K/V heads, rotate-half
RoPE with the llama3 frequency scaling, SwiGLU. The attention is a plain
causal and padding-masked softmax at T=128 (no kernel, as in uce_tpu).

Params are a dict of tensors with the per-layer weights in a list, linear
weights in HF's [out, in] layout.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

# (params name, HF key under "layers.{i}.") of each layer's weights
_LAYER_KEYS = {
    "ln1": "input_layernorm.weight",
    "q": "self_attn.q_proj.weight",
    "k": "self_attn.k_proj.weight",
    "v": "self_attn.v_proj.weight",
    "o": "self_attn.o_proj.weight",
    "ln2": "post_attention_layernorm.weight",
    "gate": "mlp.gate_proj.weight",
    "up": "mlp.up_proj.weight",
    "down": "mlp.down_proj.weight",
}


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # a hashable tuple of (key, value) pairs; rope_frequencies reads it
    rope_scaling: tuple | None = None
    head_dim: int | None = None

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "LlamaConfig":
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=(tuple(sorted(cfg["rope_scaling"].items()))
                          if cfg.get("rope_scaling") else None),
            head_dim=cfg.get("head_dim"),
        )

    def to_hf(self) -> dict:
        d = dataclasses.asdict(self)
        d["rope_scaling"] = dict(self.rope_scaling) if self.rope_scaling else None
        if d["head_dim"] is None:
            del d["head_dim"]
        return {"architectures": ["LlamaForCausalLM"], "model_type": "llama", **d}

    @property
    def dh(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads


# meta-llama/Meta-Llama-3.1-8B-Instruct config.json (HiDream-I1's text_encoder_4)
LLAMA31_8B_CONFIG = LlamaConfig(
    rope_scaling=(("factor", 8.0), ("high_freq_factor", 4.0), ("low_freq_factor", 1.0),
                  ("original_max_position_embeddings", 8192), ("rope_type", "llama3")))


def _rms_norm(x, scale, eps: float):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_frequencies(config: LlamaConfig) -> np.ndarray:
    """Inverse frequencies [dh/2] fp32 (computed in float64), with the
    llama3 long-context scaling when the config has it."""
    dh = config.dh
    inv = 1.0 / (config.rope_theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    rs = dict(config.rope_scaling) if config.rope_scaling else None
    if rs and rs.get("rope_type", rs.get("type")) == "llama3":
        factor = rs["factor"]
        lo, hi = rs["low_freq_factor"], rs["high_freq_factor"]
        orig = rs["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv
        lo_wl, hi_wl = orig / lo, orig / hi
        scaled = np.where(wavelen > lo_wl, inv / factor, inv)
        smooth = (orig / wavelen - lo) / (hi - lo)
        smoothed = (1 - smooth) / factor * inv + smooth * inv
        is_mid = (wavelen <= lo_wl) & (wavelen >= hi_wl)
        inv = np.where(is_mid, smoothed, scaled)
    return inv.astype(np.float32)


def _apply_rope(x, cos, sin):
    """x [B, H, T, Dh]; rotate-half convention (HF)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def convert_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                          config: LlamaConfig) -> dict:
    """HF Llama state dict (``model.`` prefix or none; ``lm_head`` ignored)
    -> params (same tensor layouts)."""
    prefix = "model." if any(k.startswith("model.") for k in state_dict) else ""
    return {
        "token_embedding": state_dict[prefix + "embed_tokens.weight"],
        "layers": [{n: state_dict[f"{prefix}layers.{i}.{key}"]
                    for n, key in _LAYER_KEYS.items()}
                   for i in range(config.num_hidden_layers)],
        "final_ln": state_dict[prefix + "norm.weight"],
    }


def encode_tokens(params: dict, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor | None,
                  config: LlamaConfig) -> torch.Tensor:
    """input_ids [B, T] -> every hidden state stacked [L + 1, B, T, D]: HF's
    output_hidden_states (embeddings, out_1, ..., out_{L-1}, then the
    final-RMSNormed out_L). ``attention_mask`` [B, T] (1 = real token)
    masks pad keys on top of the causal mask."""
    eps = config.rms_norm_eps
    H, KV, Dh = config.num_attention_heads, config.num_key_value_heads, config.dh
    B, T = input_ids.shape
    emb = params["token_embedding"]
    dev = emb.device

    inv_freq = torch.as_tensor(rope_frequencies(config), device=dev)
    angles = torch.arange(T, dtype=torch.float32, device=dev)[:, None] * inv_freq[None]
    angles = torch.cat([angles, angles], dim=-1)  # [T, Dh]
    cos, sin = torch.cos(angles)[None, None], torch.sin(angles)[None, None]

    keep = torch.ones(T, T, dtype=torch.bool, device=dev).tril()[None, None]
    if attention_mask is not None:
        keep = keep & (torch.as_tensor(attention_mask, device=dev)[:, None, None, :] != 0)
    neg = torch.finfo(torch.float32).min

    x = emb[torch.as_tensor(input_ids, device=dev)]
    hidden = [x]
    for p in params["layers"]:
        h = _rms_norm(x, p["ln1"], eps)
        q = F.linear(h, p["q"]).reshape(B, T, H, Dh).transpose(1, 2)
        k = F.linear(h, p["k"]).reshape(B, T, KV, Dh).transpose(1, 2)
        v = F.linear(h, p["v"]).reshape(B, T, KV, Dh).transpose(1, 2)
        q, k = _apply_rope(q, cos, sin), _apply_rope(k, cos, sin)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (Dh ** -0.5)
        probs = torch.softmax(logits.masked_fill(~keep, neg), dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * Dh)
        x = x + F.linear(attn, p["o"])
        h = _rms_norm(x, p["ln2"], eps)
        x = x + F.linear(F.silu(F.linear(h, p["gate"])) * F.linear(h, p["up"]), p["down"])
        hidden.append(x)
    hidden[-1] = final_norm(params, x, config)
    return torch.stack(hidden)


def final_norm(params: dict, hidden: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    return _rms_norm(hidden, params["final_ln"], config.rms_norm_eps)


def state_dict_shapes(config: LlamaConfig) -> dict[str, tuple]:
    """Every key of the HF Llama state dict but ``lm_head`` (which the
    encoder never reads) with its shape, ``model.``-prefixed as in a
    LlamaForCausalLM checkpoint."""
    D, F_, L = config.hidden_size, config.intermediate_size, config.num_hidden_layers
    inner, kv_inner = (config.num_attention_heads * config.dh,
                       config.num_key_value_heads * config.dh)
    layer = {"ln1": (D,), "q": (inner, D), "k": (kv_inner, D), "v": (kv_inner, D),
             "o": (D, inner), "ln2": (D,), "gate": (F_, D), "up": (F_, D),
             "down": (D, F_)}
    shapes = {"model.embed_tokens.weight": (config.vocab_size, D),
              "model.norm.weight": (D,)}
    for i in range(L):
        for name, shape in layer.items():
            shapes[f"model.layers.{i}.{_LAYER_KEYS[name]}"] = shape
    return shapes


def init_state_dict(config: LlamaConfig, seed: int = 0, scale: float = 0.02,
                    device="cuda", dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Seeded random state dict in HF Llama keys, drawn on ``device`` by a
    ``torch.Generator`` of that device (Llama-3.1-8B without its LM head is
    7.5 B parameters: 15 GB in bf16): weights N(0, scale^2), norm scales 1."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(int(seed))
    return {key: (torch.ones(shape, device=device, dtype=dtype) if len(shape) == 1
                  else torch.randn(shape, generator=gen, device=device,
                                   dtype=dtype).mul_(scale))
            for key, shape in state_dict_shapes(config).items()}
