"""Full CLIP (vision tower, text tower, scaled cosine similarity) for
zero-shot classification: the classifier of the debias loop and of
``eval-clip-classify``.

Replaces the reference's HF ``pipeline("zero-shot-image-classification")``
(``trainscripts/uce_sd_debias.py:245-250``) and ``CLIPModel`` in
``evalscripts/CLIP_classify.py``, and runs on the card against generated
uint8 images with no PIL round trip. Params keep HF layouts (linear [out,
in], the patch conv OIHW); the vision tower's attention (ViT-B/32: 50
tokens) runs the plain path, as in uce_tpu.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from uce_tpu_torch.edit.embeddings import tokenize_batch
from uce_tpu_torch.models import clip_text
from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict
from uce_tpu_torch.models.layers import layer_norm, linear
from uce_tpu_torch.ops.attention import dot_product_attention

# OpenAI CLIP preprocessing constants
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5

    @classmethod
    def from_hf(cls, cfg: Mapping) -> "CLIPVisionConfig":
        # sparse vision_config dicts of composite CLIP checkpoints fall back
        # to transformers' CLIPVisionConfig defaults, which are these
        return cls(**{f.name: cfg.get(f.name, f.default)
                      for f in dataclasses.fields(cls)})

    def to_hf(self) -> dict:
        return dataclasses.asdict(self)


def convert_hf_vision_state_dict(state_dict: Mapping[str, torch.Tensor],
                                 config: CLIPVisionConfig) -> dict:
    """HF CLIP vision state dict (``vision_model.*``, optional
    ``visual_projection.weight``) -> the port's params, same layouts."""
    prefix = "vision_model." if any(k.startswith("vision_model.")
                                    for k in state_dict) else ""
    g = lambda k: state_dict[prefix + k]
    params = {
        "patch_embedding": g("embeddings.patch_embedding.weight"),
        "class_embedding": g("embeddings.class_embedding"),
        "position_embedding": g("embeddings.position_embedding.weight"),
        "pre_ln_scale": g("pre_layrnorm.weight"),
        "pre_ln_bias": g("pre_layrnorm.bias"),
        "layers": [
            {name: g(f"encoder.layers.{i}.{key}")
             for name, key in clip_text._LAYER_KEYS.items()}
            for i in range(config.num_hidden_layers)
        ],
        "post_ln_scale": g("post_layernorm.weight"),
        "post_ln_bias": g("post_layernorm.bias"),
    }
    if "visual_projection.weight" in state_dict:
        params["visual_projection"] = state_dict["visual_projection.weight"]
    return params


def init_state_dict(config: CLIPVisionConfig, rng: np.random.Generator,
                    scale: float = 0.02) -> dict[str, np.ndarray]:
    """Random HF-named vision state dict with its visual projection (smoke
    runs, tests)."""
    D, I, P = config.hidden_size, config.intermediate_size, config.patch_size
    n = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    ones = lambda c: np.ones(c, np.float32)
    zeros = lambda c: np.zeros(c, np.float32)
    pre = "vision_model."
    sd = {
        pre + "embeddings.patch_embedding.weight": n(D, 3, P, P),
        pre + "embeddings.class_embedding": n(D),
        pre + "embeddings.position_embedding.weight":
            n((config.image_size // P) ** 2 + 1, D),
        pre + "pre_layrnorm.weight": ones(D), pre + "pre_layrnorm.bias": zeros(D),
        pre + "post_layernorm.weight": ones(D), pre + "post_layernorm.bias": zeros(D),
        "visual_projection.weight": n(config.projection_dim, D),
    }
    for i in range(config.num_hidden_layers):
        lp = f"{pre}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[lp + ln + ".weight"], sd[lp + ln + ".bias"] = ones(D), zeros(D)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[lp + f"self_attn.{proj}.weight"] = n(D, D)
            sd[lp + f"self_attn.{proj}.bias"] = zeros(D)
        sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = n(I, D), zeros(I)
        sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = n(D, I), zeros(D)
    return sd


def encode_image(params: dict, pixels: torch.Tensor,
                 config: CLIPVisionConfig) -> torch.Tensor:
    """pixels [B, 3, H, W] (CLIP-normalized) -> image embeds [B,
    projection_dim], before normalization."""
    act = clip_text._act(config.hidden_act)
    eps = config.layer_norm_eps
    H = config.num_attention_heads
    B, D = pixels.shape[0], config.hidden_size
    Dh = D // H

    patches = F.conv2d(pixels, params["patch_embedding"], stride=config.patch_size)
    patches = patches.flatten(2).transpose(1, 2)  # [B, N, D], row-major patches
    cls = params["class_embedding"].expand(B, 1, D)
    x = torch.cat([cls, patches], dim=1)
    T = x.shape[1]
    x = x + params["position_embedding"][:T]
    x = layer_norm(x, params["pre_ln_scale"], params["pre_ln_bias"], eps)

    def heads(z):
        return z.reshape(B, T, H, Dh).transpose(1, 2)

    for p in params["layers"]:
        h = layer_norm(x, p["ln1_scale"], p["ln1_bias"], eps)
        q = heads(linear(h, p["q_w"], p["q_b"]))
        k = heads(linear(h, p["k_w"], p["k_b"]))
        v = heads(linear(h, p["v_w"], p["v_b"]))
        attn = dot_product_attention(q, k, v)
        x = x + linear(attn.transpose(1, 2).reshape(B, T, D), p["o_w"], p["o_b"])
        h = layer_norm(x, p["ln2_scale"], p["ln2_bias"], eps)
        x = x + linear(act(linear(h, p["fc1_w"], p["fc1_b"])), p["fc2_w"], p["fc2_b"])
    pooled = layer_norm(x[:, 0], params["post_ln_scale"], params["post_ln_bias"], eps)
    if "visual_projection" in params:
        pooled = linear(pooled, params["visual_projection"])
    return pooled


def preprocess_images(images, image_size: int = 224, device="cuda") -> torch.Tensor:
    """uint8 [B, H, W, 3] (numpy or tensor) -> CLIP-normalized fp32 [B, 3,
    S, S] on ``device``.

    CLIPProcessor's steps: resize the shorter side to S (bicubic), center
    crop, rescale by 1/255, normalize. The resize antialiases when it
    shrinks, as ``jax.image.resize`` does (uce_tpu), so it agrees with
    uce_tpu at every source size, upsampling and non-square included.
    """
    x = torch.as_tensor(np.asarray(images)).to(device)  # upload as uint8
    x = x.permute(0, 3, 1, 2).float() / 255.0
    h, w = x.shape[-2:]
    if h != image_size or w != image_size:
        short = min(h, w)
        nh, nw = int(round(h * image_size / short)), int(round(w * image_size / short))
        x = F.interpolate(x, size=(nh, nw), mode="bicubic", antialias=True,
                          align_corners=False)
        top, left = (nh - image_size) // 2, (nw - image_size) // 2
        x = x[..., top:top + image_size, left:left + image_size]
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


@dataclasses.dataclass
class CLIPModel:
    """Dual-tower CLIP with the checkpoint's logit scale, on ``device``."""

    vision_params: dict
    vision_config: CLIPVisionConfig
    text_params: dict
    text_config: clip_text.CLIPTextConfig
    tokenizer: object
    logit_scale: float = 100.0
    device: torch.device = torch.device("cuda")
    # text embeddings memoized per label tuple (embed_texts)
    _text_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                          repr=False)

    @classmethod
    def from_pretrained(cls, model_dir: str, device="cuda") -> "CLIPModel":
        """A composite CLIP snapshot (config.json with ``text_config`` and
        ``vision_config``, safetensors, vocab.json and merges.txt at its
        root), e.g. openai/clip-vit-base-patch32."""
        device = torch.device(device)
        cfg = load_json(os.path.join(model_dir, "config.json"))
        proj = cfg.get("projection_dim", 512)
        tcfg = clip_text.CLIPTextConfig.from_hf(
            dict(cfg["text_config"], projection_dim=proj), diff_defaults=True)
        vcfg = CLIPVisionConfig.from_hf(dict(cfg["vision_config"], projection_dim=proj))
        sd = {k: v.to(device) for k, v in
              load_state_dict(model_dir, None, dtype=torch.float32).items()}
        text_sd = {k: v for k, v in sd.items()
                   if k.startswith("text_model.") or k == "text_projection.weight"}
        logit_scale = sd.get("logit_scale")
        return cls(
            vision_params=convert_hf_vision_state_dict(sd, vcfg),
            vision_config=vcfg,
            text_params=clip_text.convert_hf_state_dict(text_sd, tcfg),
            text_config=tcfg,
            tokenizer=CLIPTokenizer.from_pretrained(model_dir),
            logit_scale=(100.0 if logit_scale is None
                         else float(np.exp(float(logit_scale)))),
            device=device)

    @torch.inference_mode()
    def embed_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """Projected pooled text embeds [N, P], memoized per label tuple: a
        zero-shot pass over a folder asks for the same labels every batch."""
        key = tuple(texts)
        cache = self._text_cache
        if key not in cache:
            ids, _ = tokenize_batch(self.tokenizer, list(texts),
                                    self.text_config.max_position_embeddings)
            _, pooled, _ = clip_text.encode_tokens(
                self.text_params, torch.as_tensor(ids, device=self.device),
                self.text_config)
            cache[key] = pooled
            if len(cache) > 64:  # arbitrary label sets: bound the cache
                cache.pop(next(iter(cache)))
        return cache[key]

    @torch.inference_mode()
    def embed_images(self, images) -> torch.Tensor:
        """uint8 [B, H, W, 3] -> projected image embeds [B, P]."""
        pixels = preprocess_images(images, self.vision_config.image_size, self.device)
        return encode_image(self.vision_params, pixels, self.vision_config)

    @torch.inference_mode()
    def logits_per_image(self, images, texts: Sequence[str]) -> np.ndarray:
        img = self.embed_images(images)
        txt = self.embed_texts(texts)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        return (self.logit_scale * img @ txt.T).cpu().numpy()

    def classify(self, images, candidate_labels: Sequence[str]) -> np.ndarray:
        """Zero-shot label index per image (argmax over the candidates)."""
        return self.logits_per_image(images, list(candidate_labels)).argmax(-1)
