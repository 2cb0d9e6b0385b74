"""T5 encoder (FLUX's text_encoder_2: T5 v1.1-XXL).

T5's specifics, as ``uce_tpu/models/t5.py`` has them: RMS layer norm in
fp32 (no mean subtraction, no bias), unscaled attention logits (no
1/sqrt(d_kv)) computed and kept in fp32, one bucketed relative position
bias computed once and shared by every layer, and a gated tanh-GELU (v1.1)
or ReLU feed-forward.

The attention takes an additive bias, so it stays plain PyTorch here, as
``uce_tpu`` keeps it outside any Pallas kernel.

Params are a dict of tensors with the per-layer weights in a list, linear
weights in HF's [out, in] layout, the position bias table [buckets, heads].
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

# (params name, HF key under "block.{i}.") of each layer's weights
_LAYER_KEYS = {
    "ln1": "layer.0.layer_norm.weight",
    "q": "layer.0.SelfAttention.q.weight",
    "k": "layer.0.SelfAttention.k.weight",
    "v": "layer.0.SelfAttention.v.weight",
    "o": "layer.0.SelfAttention.o.weight",
    "ln2": "layer.1.layer_norm.weight",
    "wi": "layer.1.DenseReluDense.wi.weight",
    "wi_0": "layer.1.DenseReluDense.wi_0.weight",
    "wi_1": "layer.1.DenseReluDense.wi_1.weight",
    "wo": "layer.1.DenseReluDense.wo.weight",
}
_REL_BIAS = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    is_gated_act: bool = True
    dense_act_fn: str = "gelu_new"

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "T5Config":
        return cls(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["d_model"],
            d_kv=cfg["d_kv"],
            d_ff=cfg["d_ff"],
            num_layers=cfg["num_layers"],
            num_heads=cfg["num_heads"],
            relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
            is_gated_act=cfg.get("is_gated_act",
                                 "gated" in cfg.get("feed_forward_proj", "")),
            dense_act_fn=cfg.get("dense_act_fn",
                                 cfg.get("feed_forward_proj", "relu").replace("gated-", "")),
        )

    def to_hf(self) -> dict:
        return {"architectures": ["T5EncoderModel"], "model_type": "t5",
                **dataclasses.asdict(self)}


# google/t5-v1_1-xxl's encoder (FLUX.1's text_encoder_2/config.json)
T5_XXL_CONFIG = T5Config()


def _rms_norm(x, scale, eps: float):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _act(name: str):
    if name in ("gelu_new", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    raise ValueError(name)


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional (encoder) T5 relative position bucketing, on the host."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel_abs = np.abs(rel)
    max_exact = nb // 2
    is_small = rel_abs < max_exact
    large = max_exact + (
        np.log(np.maximum(rel_abs, 1) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(is_small, rel_abs, large)


def convert_hf_state_dict(state_dict: Mapping[str, torch.Tensor],
                          config: T5Config) -> dict:
    """HF T5EncoderModel state dict (``encoder.`` prefix or none) -> params
    (same tensor layouts)."""
    prefix = "encoder." if any(k.startswith("encoder.") for k in state_dict) else ""
    ff = ("wi_0", "wi_1") if config.is_gated_act else ("wi",)
    names = ("ln1", "q", "k", "v", "o", "ln2", *ff, "wo")
    shared = "shared.weight" if "shared.weight" in state_dict else prefix + "embed_tokens.weight"
    return {
        "token_embedding": state_dict[shared],
        "rel_bias": state_dict[prefix + _REL_BIAS],
        "layers": [{n: state_dict[f"{prefix}block.{i}.{_LAYER_KEYS[n]}"] for n in names}
                   for i in range(config.num_layers)],
        "final_ln": state_dict[prefix + "final_layer_norm.weight"],
    }


def encode_tokens(params: dict, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor | None, config: T5Config) -> torch.Tensor:
    """input_ids [B, T] -> last hidden state [B, T, d_model] in the params'
    dtype. ``attention_mask`` [B, T] (1 = real token) masks pad keys; FLUX
    passes None (pad tokens attend, as diffusers' FluxPipeline)."""
    eps = config.layer_norm_epsilon
    H, Dh = config.num_heads, config.d_kv
    act = _act(config.dense_act_fn)
    B, T = input_ids.shape

    def heads(z):
        return z.reshape(B, T, H, Dh).transpose(1, 2)

    x = params["token_embedding"][input_ids]
    buckets = relative_position_buckets(T, T, config.relative_attention_num_buckets,
                                        config.relative_attention_max_distance)
    rel_bias = params["rel_bias"]
    # position bias [1, H, T, T] in fp32, shared by every layer
    bias = rel_bias[torch.as_tensor(buckets, device=rel_bias.device)]
    bias = bias.permute(2, 0, 1)[None].float()
    if attention_mask is not None:
        pad = torch.as_tensor(attention_mask, device=bias.device)[:, None, None, :] == 0
        bias = bias + torch.where(pad, torch.finfo(torch.float32).min, 0.0)

    for p in params["layers"]:
        h = _rms_norm(x, p["ln1"], eps)
        q, k, v = heads(F.linear(h, p["q"])), heads(F.linear(h, p["k"])), heads(F.linear(h, p["v"]))
        # unscaled logits, products and sums in fp32, plus the position bias
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, H * Dh)
        x = x + F.linear(attn, p["o"])
        h = _rms_norm(x, p["ln2"], eps)
        if config.is_gated_act:
            ff = act(F.linear(h, p["wi_0"])) * F.linear(h, p["wi_1"])
        else:
            ff = act(F.linear(h, p["wi"]))
        x = x + F.linear(ff, p["wo"])
    return _rms_norm(x, params["final_ln"], eps)


def state_dict_shapes(config: T5Config) -> dict[str, tuple]:
    """Every key of the HF T5EncoderModel state dict with its shape (the
    contract of ``tests/snapshot.py::_write_t5_encoder``)."""
    D, F_, H = config.d_model, config.d_ff, config.num_heads
    inner = H * config.d_kv
    shapes = {"shared.weight": (config.vocab_size, D),
              "encoder.final_layer_norm.weight": (D,),
              "encoder." + _REL_BIAS: (config.relative_attention_num_buckets, H)}
    ff = {"wi_0": (F_, D), "wi_1": (F_, D)} if config.is_gated_act else {"wi": (F_, D)}
    layer = {"ln1": (D,), "q": (inner, D), "k": (inner, D), "v": (inner, D),
             "o": (D, inner), "ln2": (D,), **ff, "wo": (D, F_)}
    for i in range(config.num_layers):
        for name, shape in layer.items():
            shapes[f"encoder.block.{i}.{_LAYER_KEYS[name]}"] = shape
    return shapes


def init_state_dict(config: T5Config, seed: int = 0, scale: float = 0.02,
                    device="cuda", dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Seeded random state dict in HF T5EncoderModel keys, drawn on
    ``device`` by a ``torch.Generator`` of that device: weights N(0,
    scale^2), norm scales 1."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(int(seed))
    return {key: (torch.ones(shape, device=device, dtype=dtype) if len(shape) == 1
                  else torch.randn(shape, generator=gen, device=device,
                                   dtype=dtype).mul_(scale))
            for key, shape in state_dict_shapes(config).items()}
