"""Plain float32 CLIP text transformer (SD v1's prompt encoder), over
Hugging Face state dict names."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _lin(p, name, x):
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def _ln(p, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def clip_encode(p, cfg, ids):
    """ids [B, T] -> (last hidden state [B, T, D], pooled [B, D]): causal
    pre-LN transformer with quick_gelu, pooled at the largest id (the eos,
    as transformers pools for a config whose eos_token_id is the legacy 2)
    or at the config's eos_token_id."""
    b, t = ids.shape
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg.get("layer_norm_eps", 1e-5)
    pre = "text_model."
    x = p[pre + "embeddings.token_embedding.weight"][ids] \
        + p[pre + "embeddings.position_embedding.weight"][:t]
    mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    split = lambda z: z.reshape(b, t, h, d // h).transpose(1, 2)
    for i in range(cfg["num_hidden_layers"]):
        L = f"{pre}encoder.layers.{i}."
        y = _ln(p, L + "layer_norm1", x, eps)
        q, k, v = (split(_lin(p, L + f"self_attn.{n}_proj", y)) for n in "qkv")
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * (d // h) ** -0.5
                              + mask, dim=-1)
        x = x + _lin(p, L + "self_attn.out_proj",
                     (probs @ v).transpose(1, 2).reshape(b, t, d))
        y = _lin(p, L + "mlp.fc1", _ln(p, L + "layer_norm2", x, eps))
        x = x + _lin(p, L + "mlp.fc2", y * torch.sigmoid(1.702 * y))
    last = _ln(p, pre + "final_layer_norm", x, eps)
    eos = cfg.get("eos_token_id")
    at = ids.argmax(-1) if eos in (None, 2) else (ids == eos).int().argmax(-1)
    return last, last[torch.arange(b, device=ids.device), at]


def clip_shapes(cfg) -> dict[str, tuple]:
    d, inner = cfg["hidden_size"], cfg["intermediate_size"]
    pre = "text_model."
    s = {pre + "embeddings.token_embedding.weight": (cfg["vocab_size"], d),
         pre + "embeddings.position_embedding.weight": (cfg["max_position_embeddings"], d),
         pre + "final_layer_norm.weight": (d,), pre + "final_layer_norm.bias": (d,)}
    for i in range(cfg["num_hidden_layers"]):
        L = f"{pre}encoder.layers.{i}."
        for n in ("layer_norm1", "layer_norm2"):
            s[L + n + ".weight"], s[L + n + ".bias"] = (d,), (d,)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[L + f"self_attn.{n}.weight"], s[L + f"self_attn.{n}.bias"] = (d, d), (d,)
        s[L + "mlp.fc1.weight"], s[L + "mlp.fc1.bias"] = (inner, d), (inner,)
        s[L + "mlp.fc2.weight"], s[L + "mlp.fc2.bias"] = (d, inner), (d,)
    return s

