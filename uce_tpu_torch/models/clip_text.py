"""CLIP text encoder (the SD v1.x, v2.x and SDXL prompt encoders): causal,
pre-LN, OpenAI CLIP's quick_gelu (SD v1.x, SDXL's first encoder) or
OpenCLIP's exact-erf gelu (SD v2.x, SDXL's second encoder), eos pooling and
an optional text projection of the pooled vector (SDXL's second encoder).

Params are a dict of tensors with the per-layer weights in a list, linear
weights in HF's [out, in] layout.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.models.layers import layer_norm, linear
from uce_tpu_torch.ops.attention import dot_product_attention

_LAYER_KEYS = {
    "ln1_scale": "layer_norm1.weight", "ln1_bias": "layer_norm1.bias",
    "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
    "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
    "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
    "o_w": "self_attn.out_proj.weight", "o_b": "self_attn.out_proj.bias",
    "ln2_scale": "layer_norm2.weight", "ln2_bias": "layer_norm2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: int | None = None
    layer_norm_eps: float = 1e-5
    eos_token_id: int | None = 49407

    @classmethod
    def from_hf(cls, cfg: Mapping, diff_defaults: bool = False) -> "CLIPTextConfig":
        """A text_encoder config.json (every structural key required), or
        with ``diff_defaults`` the ``text_config`` of a composite CLIP
        checkpoint (openai/clip-vit-base-patch32), a diff from transformers'
        CLIPTextConfig defaults (512 wide, 8 heads, ...)."""
        if diff_defaults:
            cfg = {"vocab_size": 49408, "hidden_size": 512, "num_hidden_layers": 12,
                   "num_attention_heads": 8, "intermediate_size": 2048, **cfg}
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            eos_token_id=cfg.get("eos_token_id", 49407),
            max_position_embeddings=cfg.get("max_position_embeddings", 77),
            hidden_act=cfg.get("hidden_act", "quick_gelu"),
            projection_dim=cfg.get("projection_dim"),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        )

    def to_hf(self) -> dict:
        arch = "CLIPTextModelWithProjection" if self.projection_dim else "CLIPTextModel"
        return {"architectures": [arch], **dataclasses.asdict(self)}


# SD v1.x (CompVis/stable-diffusion-v1-4 text_encoder/config.json)
SD14_TEXT_CONFIG = CLIPTextConfig()
# SD v2.x (OpenCLIP ViT-H text tower)
SD2_TEXT_CONFIG = CLIPTextConfig(
    hidden_size=1024, num_hidden_layers=23, num_attention_heads=16,
    intermediate_size=4096, hidden_act="gelu")
# SDXL's second encoder (OpenCLIP ViT-bigG, with projection)
SDXL_TEXT2_CONFIG = CLIPTextConfig(
    hidden_size=1280, num_hidden_layers=32, num_attention_heads=20,
    intermediate_size=5120, hidden_act="gelu", projection_dim=1280)


def _act(name: str):
    """uce_tpu's activations: quick_gelu, exact-erf gelu, tanh gelu."""
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        approximate = "none" if name == "gelu" else "tanh"
        return lambda x: F.gelu(x, approximate=approximate)
    raise ValueError(f"unsupported activation: {name}")


def convert_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                          config: CLIPTextConfig) -> dict:
    """HF CLIPTextModel state dict -> port params (same tensor layouts)."""
    prefix = "text_model." if any(k.startswith("text_model.")
                                  for k in state_dict) else ""
    g = lambda k: state_dict[prefix + k]
    params = {
        "token_embedding": g("embeddings.token_embedding.weight"),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "layers": [
            {name: g(f"encoder.layers.{i}.{key}")
             for name, key in _LAYER_KEYS.items()}
            for i in range(config.num_hidden_layers)
        ],
        "final_ln_scale": g("final_layer_norm.weight"),
        "final_ln_bias": g("final_layer_norm.bias"),
    }
    if "text_projection.weight" in state_dict:
        params["text_projection"] = state_dict["text_projection.weight"]
    return params


def init_state_dict(config: CLIPTextConfig, rng: np.random.Generator,
                    scale: float = 0.02) -> dict[str, np.ndarray]:
    """Random HF-named state dict (tests, smoke runs)."""
    D, I = config.hidden_size, config.intermediate_size
    n = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    ones = lambda c: np.ones(c, np.float32)
    zeros = lambda c: np.zeros(c, np.float32)
    sd = {
        "text_model.embeddings.token_embedding.weight": n(config.vocab_size, D),
        "text_model.embeddings.position_embedding.weight":
            n(config.max_position_embeddings, D),
        "text_model.final_layer_norm.weight": ones(D),
        "text_model.final_layer_norm.bias": zeros(D),
    }
    for i in range(config.num_hidden_layers):
        pre = f"text_model.encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[pre + ln + ".weight"] = ones(D)
            sd[pre + ln + ".bias"] = zeros(D)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[pre + f"self_attn.{proj}.weight"] = n(D, D)
            sd[pre + f"self_attn.{proj}.bias"] = zeros(D)
        sd[pre + "mlp.fc1.weight"] = n(I, D)
        sd[pre + "mlp.fc1.bias"] = zeros(I)
        sd[pre + "mlp.fc2.weight"] = n(D, I)
        sd[pre + "mlp.fc2.bias"] = zeros(D)
    if config.projection_dim:
        sd["text_projection.weight"] = n(config.projection_dim, D)
    return sd


def init_params(rng: np.random.Generator, config: CLIPTextConfig) -> dict:
    sd = {k: torch.from_numpy(v) for k, v in init_state_dict(config, rng).items()}
    return convert_hf_state_dict(sd, config)


def encode_tokens(params: dict, input_ids: torch.Tensor, config: CLIPTextConfig,
                  *, output_hidden_states: bool = False):
    """input_ids [B, T] -> (last_hidden [B, T, D], pooled [B, D or
    projection_dim], hiddens).

    ``hiddens`` is the list of per-layer outputs when asked for, else None.
    Pooling is at the eos position; real SD/SDXL text configs carry the
    legacy ``eos_token_id == 2`` while the tokenizer's eos is the largest
    id, so that sentinel (and None) pools at the argmax of the ids, as
    transformers does. With a text projection the pooled vector is
    projected (SDXL's second encoder).
    """
    act = _act(config.hidden_act)
    eps = config.layer_norm_eps
    H = config.num_attention_heads
    B, T = input_ids.shape
    D = config.hidden_size
    Dh = D // H

    def heads(z):
        return z.reshape(B, T, H, Dh).transpose(1, 2)

    x = params["token_embedding"][input_ids] + params["position_embedding"][:T]
    hiddens = [] if output_hidden_states else None
    for p in params["layers"]:
        h = layer_norm(x, p["ln1_scale"], p["ln1_bias"], eps)
        q = heads(linear(h, p["q_w"], p["q_b"]))
        k = heads(linear(h, p["k_w"], p["k_b"]))
        v = heads(linear(h, p["v_w"], p["v_b"]))
        attn = dot_product_attention(q, k, v, causal=True)
        x = x + linear(attn.transpose(1, 2).reshape(B, T, D), p["o_w"], p["o_b"])
        h = layer_norm(x, p["ln2_scale"], p["ln2_bias"], eps)
        x = x + linear(act(linear(h, p["fc1_w"], p["fc1_b"])),
                       p["fc2_w"], p["fc2_b"])
        if hiddens is not None:
            hiddens.append(x)
    last = layer_norm(x, params["final_ln_scale"], params["final_ln_bias"], eps)
    if config.eos_token_id is None or config.eos_token_id == 2:
        eos_idx = input_ids.argmax(-1)
    else:
        eos_idx = (input_ids == config.eos_token_id).int().argmax(-1)
    pooled = last[torch.arange(B, device=last.device), eos_idx]
    if "text_projection" in params:
        pooled = linear(pooled, params["text_projection"])
    return last, pooled, hiddens
