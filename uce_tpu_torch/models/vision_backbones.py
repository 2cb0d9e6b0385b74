"""Vision backbones of the eval suite (uce_tpu/models/vision_backbones.py):
AlexNet (LPIPS), VGG19 (style loss), ResNet-50 (ImageNet classification)
and the pre-norm ViT of timm (DreamSim's backbones), as functions of their
params, and loaders of torchvision- and timm-format state dicts.

NCHW fp32 throughout; params keep torchvision's layouts (conv OIHW, linear
weights [out, in]). The convs are plain ``F.conv2d`` in fp32, never the
bf16 conv3x3 kernel, as uce_tpu keeps them off its Pallas conv; the ViT's
attention (T = 197 at 224²) is below the attention kernel's routing rule.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _tensor(v) -> torch.Tensor:
    """A state-dict value (tensor or array) as an fp32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(v, np.float32))


def _conv(x, p, stride=1, padding=1):
    return F.conv2d(x, p["weight"], p["bias"], stride=stride, padding=padding)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 0) -> torch.Tensor:
    """Max over windows, padded with -inf, no partial windows at the end
    (``jax.lax.reduce_window`` with uce_tpu's arguments)."""
    return F.max_pool2d(x, window, stride, padding)


def _conv_p(sd: Mapping, name: str) -> dict:
    return {"weight": _tensor(sd[name + ".weight"]), "bias": _tensor(sd[name + ".bias"])}


def params_to(params, device) -> dict:
    """A params tree with every tensor on ``device``."""
    if isinstance(params, Mapping):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return params.to(device)


# AlexNet .features (torchvision): the convs at indices 0, 3, 6, 8, 10

ALEXNET_CONV_IDX = (0, 3, 6, 8, 10)
ALEXNET_CHANNELS = (64, 192, 384, 256, 256)


def convert_alexnet(sd: Mapping) -> dict:
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    return {f"conv{i}": _conv_p(sd, f"{prefix}{idx}")
            for i, idx in enumerate(ALEXNET_CONV_IDX)}


def alexnet_features(params: dict, x: torch.Tensor) -> list[torch.Tensor]:
    """x [B, 3, H, W] -> the ReLU outputs of the 5 conv stages (LPIPS taps)."""
    taps = []
    h = F.relu(_conv(x, params["conv0"], stride=4, padding=2))
    taps.append(h)
    h = max_pool(h)
    h = F.relu(_conv(h, params["conv1"], padding=2))
    taps.append(h)
    h = max_pool(h)
    for i in (2, 3, 4):
        h = F.relu(_conv(h, params[f"conv{i}"]))
        taps.append(h)
    return taps


# VGG19 .features

VGG19_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def convert_vgg19(sd: Mapping) -> dict:
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    params, idx, conv_i = {}, 0, 0
    for item in VGG19_LAYOUT:
        if item == "M":
            idx += 1
            continue
        if f"{prefix}{idx}.weight" not in sd:
            break  # a truncated snapshot (the style loss needs conv_1..5)
        params[f"conv{conv_i}"] = _conv_p(sd, f"{prefix}{idx}")
        conv_i += 1
        idx += 2  # conv + relu
    return params


def vgg19_features(params: dict, x: torch.Tensor,
                   num_convs: int | None = None) -> list[torch.Tensor]:
    """The conv outputs before their ReLU (the reference's styleloss.py puts
    its loss modules right after each Conv2d), conv_1, conv_2, ... in
    order."""
    taps, conv_i, h = [], 0, x
    for item in VGG19_LAYOUT:
        if item == "M":
            h = max_pool(h, window=2, stride=2)
            continue
        h = _conv(h, params[f"conv{conv_i}"])
        taps.append(h)
        conv_i += 1
        if num_convs is not None and conv_i >= num_convs:
            break
        h = F.relu(h)
    return taps


# ResNet-50 (v1.5: the stride on the 3x3 conv)

RESNET50_BLOCKS = (3, 4, 6, 3)


def convert_resnet50(sd: Mapping) -> dict:
    def bn(name):
        return {"scale": _tensor(sd[name + ".weight"]), "bias": _tensor(sd[name + ".bias"]),
                "mean": _tensor(sd[name + ".running_mean"]),
                "var": _tensor(sd[name + ".running_var"])}

    params = {"conv1": _tensor(sd["conv1.weight"]), "bn1": bn("bn1")}
    for li, n_blocks in enumerate(RESNET50_BLOCKS, start=1):
        for bi in range(n_blocks):
            base = f"layer{li}.{bi}"
            block = {}
            for ci in (1, 2, 3):
                block[f"conv{ci}"] = _tensor(sd[f"{base}.conv{ci}.weight"])
                block[f"bn{ci}"] = bn(f"{base}.bn{ci}")
            if f"{base}.downsample.0.weight" in sd:
                block["ds_conv"] = _tensor(sd[f"{base}.downsample.0.weight"])
                block["ds_bn"] = bn(f"{base}.downsample.1")
            params[f"layer{li}_{bi}"] = block
    params["fc"] = {"weight": _tensor(sd["fc.weight"]), "bias": _tensor(sd["fc.bias"])}
    return params


def _bn(x, p, eps: float = 1e-5):
    """Eval-mode BatchNorm with the running statistics."""
    view = lambda t: t.view(1, -1, 1, 1)
    inv = torch.rsqrt(view(p["var"]) + eps)
    return (x - view(p["mean"])) * inv * view(p["scale"]) + view(p["bias"])


def _bottleneck(p, x, stride: int):
    h = F.relu(_bn(F.conv2d(x, p["conv1"]), p["bn1"]))
    h = F.relu(_bn(F.conv2d(h, p["conv2"], stride=stride, padding=1), p["bn2"]))
    h = _bn(F.conv2d(h, p["conv3"]), p["bn3"])
    if "ds_conv" in p:
        x = _bn(F.conv2d(x, p["ds_conv"], stride=stride), p["ds_bn"])
    return F.relu(x + h)


def resnet50_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] (ImageNet-normalized) -> logits [B, 1000]."""
    h = F.conv2d(x, params["conv1"], stride=2, padding=3)
    h = F.relu(_bn(h, params["bn1"]))
    h = max_pool(h, window=3, stride=2, padding=1)
    for li, n_blocks in enumerate(RESNET50_BLOCKS, start=1):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and li > 1) else 1
            h = _bottleneck(params[f"layer{li}_{bi}"], h, stride)
    h = h.mean(dim=(2, 3))
    return F.linear(h, params["fc"]["weight"], params["fc"]["bias"])


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """x [B, C, H, W] float -> [B, C, *size]: ``jax.image.resize(method=
    "bilinear")``, which antialiases when it shrinks; the same size is the
    identity."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", antialias=True,
                         align_corners=False)


def normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.tensor(mean, device=x.device).view(1, -1, 1, 1)
    std = torch.tensor(std, device=x.device).view(1, -1, 1, 1)
    return (x - mean) / std


def to_unit(images, device) -> torch.Tensor:
    """uint8 [B, H, W, 3] (numpy) -> fp32 [B, 3, H, W] in [0, 1] on
    ``device`` (uploaded as uint8)."""
    x = torch.as_tensor(np.asarray(images)).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def preprocess_imagenet(images, size: int = 224, device="cuda") -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalized fp32 [B, 3, size, size] on
    ``device``: the shorter side resized to 256 (for 224; else to ``size``),
    rounded, then the floor-halved centre crop."""
    x = to_unit(images, device)
    h, w = x.shape[-2:]
    short = min(h, w)
    scale = 256 / short if size == 224 else size / short
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = resize_bilinear(x, (nh, nw))
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[..., top:top + size, left:left + size]
    return normalize(x, IMAGENET_MEAN, IMAGENET_STD)


def init_alexnet_state_dict(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Random torchvision-named AlexNet .features at its published widths:
    He-scaled weights (activations stay O(1) through the taps), small
    biases."""
    shapes = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
              (256, 384, 3, 3), (256, 256, 3, 3)]
    return _conv_state_dict(rng, zip(ALEXNET_CONV_IDX, shapes))


def init_vgg19_state_dict(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Random torchvision-named VGG19 .features (all 16 convs)."""
    convs, idx, cin = [], 0, 3
    for item in VGG19_LAYOUT:
        if item == "M":
            idx += 1
            continue
        convs.append((idx, (item, cin, 3, 3)))
        cin, idx = item, idx + 2
    return _conv_state_dict(rng, convs)


def _conv_state_dict(rng, convs) -> dict[str, np.ndarray]:
    sd = {}
    for idx, shape in convs:
        fan_in = shape[1] * shape[2] * shape[3]
        sd[f"features.{idx}.weight"] = (rng.standard_normal(shape)
                                        * np.sqrt(2.0 / fan_in)).astype(np.float32)
        sd[f"features.{idx}.bias"] = (rng.standard_normal(shape[0]) * 0.01
                                      ).astype(np.float32)
    return sd


def init_resnet50_state_dict(rng: np.random.Generator,
                             residual_gain: float = 0.2) -> dict[str, np.ndarray]:
    """Random torchvision-named ResNet-50 at its published widths: He-scaled
    convs, BatchNorm with running mean 0 and variance 1 (the identity in
    eval mode) and the last BN of each block scaled by ``residual_gain``,
    so activations stay bounded through the 16 residual blocks; an fc whose
    logits spread over several units."""
    sd = {}

    def conv(name, cout, cin, k):
        sd[name + ".weight"] = (rng.standard_normal((cout, cin, k, k))
                                * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)

    def bn(name, c, gain=1.0):
        sd[name + ".weight"] = np.full(c, gain, np.float32)
        sd[name + ".bias"] = (rng.standard_normal(c) * 0.01).astype(np.float32)
        sd[name + ".running_mean"] = np.zeros(c, np.float32)
        sd[name + ".running_var"] = np.ones(c, np.float32)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n_blocks, width) in enumerate(zip(RESNET50_BLOCKS, (64, 128, 256, 512)),
                                           start=1):
        for bi in range(n_blocks):
            base = f"layer{li}.{bi}"
            conv(f"{base}.conv1", width, cin, 1)
            bn(f"{base}.bn1", width)
            conv(f"{base}.conv2", width, width, 3)
            bn(f"{base}.bn2", width)
            conv(f"{base}.conv3", width * 4, width, 1)
            bn(f"{base}.bn3", width * 4, residual_gain)
            if bi == 0:
                conv(f"{base}.downsample.0", width * 4, cin, 1)
                bn(f"{base}.downsample.1", width * 4)
            cin = width * 4
    sd["fc.weight"] = (rng.standard_normal((1000, 2048)) * 0.1).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


# ---------------------------------------------------------------------------
# The pre-norm ViT of timm: DreamSim's backbone family (DINO, CLIP and
# OpenCLIP ViT-B are this architecture; DreamSim's LoRA deltas are merged
# into the dense weights when tools/convert_dreamsim.py writes the file).
# ---------------------------------------------------------------------------

_VIT_BLOCK_KEYS = {
    "ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
    "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
    "o_w": "attn.proj.weight", "o_b": "attn.proj.bias",
    "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}


def convert_vit_timm(sd: Mapping, num_blocks: int | None = None) -> dict:
    """timm VisionTransformer state dict -> params with one dict per block
    (linear weights [out, in], the patch conv OIHW). Keys: patch_embed.proj,
    cls_token, pos_embed, blocks.{i}.{norm1, attn.qkv, attn.proj, norm2,
    mlp.fc1, mlp.fc2}, norm; a head or projection is ignored (DreamSim takes
    the CLS embedding)."""
    if num_blocks is None:
        num_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    pos = _tensor(sd["pos_embed"])
    return {
        "patch_kernel": _tensor(sd["patch_embed.proj.weight"]),
        "patch_bias": _tensor(sd["patch_embed.proj.bias"]),
        "cls_token": _tensor(sd["cls_token"]).reshape(1, 1, -1),
        "pos_embed": pos.reshape(pos.shape[-2], pos.shape[-1]),
        "blocks": [{name: _tensor(sd[f"blocks.{i}.{key}"])
                    for name, key in _VIT_BLOCK_KEYS.items()}
                   for i in range(num_blocks)],
        "ln_scale": _tensor(sd["norm.weight"]),
        "ln_bias": _tensor(sd["norm.bias"]),
    }


def vit_cls_embed(params: dict, pixels: torch.Tensor, num_heads: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """pixels [B, 3, S, S] (already model-normalized) -> the CLS embedding
    [B, D] after the final norm (timm's forward_features CLS slot)."""
    from uce_tpu_torch.ops.attention import dot_product_attention

    p = params
    D = p["cls_token"].shape[-1]
    ps = p["patch_kernel"].shape[-1]
    x = F.conv2d(pixels, p["patch_kernel"], p["patch_bias"], stride=ps)
    B = x.shape[0]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p["cls_token"].expand(B, 1, D), x], dim=1)
    T = x.shape[1]
    x = x + p["pos_embed"][:T]
    ln = lambda v, scale, bias: F.layer_norm(v.float(), (D,), scale.float(),
                                             bias.float(), eps).to(v.dtype)
    Dh = D // num_heads

    def heads(z):
        return z.reshape(B, T, num_heads, Dh).transpose(1, 2)

    for bp in p["blocks"]:
        h = ln(x, bp["ln1_scale"], bp["ln1_bias"])
        q, k, v = F.linear(h, bp["qkv_w"], bp["qkv_b"]).chunk(3, dim=-1)
        attn = dot_product_attention(heads(q), heads(k), heads(v))
        attn = attn.transpose(1, 2).reshape(B, T, D)
        x = x + F.linear(attn, bp["o_w"], bp["o_b"])
        h = ln(x, bp["ln2_scale"], bp["ln2_bias"])
        h = F.gelu(F.linear(h, bp["fc1_w"], bp["fc1_b"]), approximate="none")
        x = x + F.linear(h, bp["fc2_w"], bp["fc2_b"])
    return ln(x, p["ln_scale"], p["ln_bias"])[:, 0]


def init_vit_timm(rng: np.random.Generator, depth: int = 2, dim: int = 32,
                  heads: int = 2, patch: int = 8, image: int = 32,
                  mlp_ratio: int = 4) -> dict[str, np.ndarray]:
    """Random flat timm-format ViT state dict, the draws of uce_tpu's."""
    n = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)
    n_pos = (image // patch) ** 2 + 1
    sd = {
        "patch_embed.proj.weight": n(dim, 3, patch, patch),
        "patch_embed.proj.bias": np.zeros(dim, np.float32),
        "cls_token": n(1, 1, dim),
        "pos_embed": n(1, n_pos, dim),
        "norm.weight": np.ones(dim, np.float32),
        "norm.bias": np.zeros(dim, np.float32),
    }
    for i in range(depth):
        b = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[b + ln + ".weight"] = np.ones(dim, np.float32)
            sd[b + ln + ".bias"] = np.zeros(dim, np.float32)
        sd[b + "attn.qkv.weight"] = n(3 * dim, dim)
        sd[b + "attn.qkv.bias"] = np.zeros(3 * dim, np.float32)
        sd[b + "attn.proj.weight"] = n(dim, dim)
        sd[b + "attn.proj.bias"] = np.zeros(dim, np.float32)
        sd[b + "mlp.fc1.weight"] = n(mlp_ratio * dim, dim)
        sd[b + "mlp.fc1.bias"] = np.zeros(mlp_ratio * dim, np.float32)
        sd[b + "mlp.fc2.weight"] = n(dim, mlp_ratio * dim)
        sd[b + "mlp.fc2.bias"] = np.zeros(dim, np.float32)
    return sd
