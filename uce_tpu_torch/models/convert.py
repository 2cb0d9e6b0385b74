"""Weight carry-over from uce_tpu's parameter trees to the port's layouts.

uce_tpu keeps nested dicts of arrays with conv kernels HWIO and linear
weights [in, out] (CLIP text, T5, Llama and the FLUX and HiDream blocks
layer-stacked as [L, ...]); the port keeps
diffusers/HF layouts (conv OIHW, linear [out, in]). Inputs are anything
``numpy.asarray`` accepts (numpy or jax arrays). A quantized leaf of
uce_tpu (``{"qint8"|"w8int": int8, "scale": [1, ..., out]}``; a stacked one
``[L, (E,) in, out]`` with scales ``[L, (E,) 1, out]``) becomes the port's
quantized weight at the same key, one per layer (and expert): its payload
in the port's layout and its scale as ``[out]``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from uce_tpu_torch.models.clip_text import _LAYER_KEYS, CLIPTextConfig
from uce_tpu_torch.models.flux import FluxConfig
from uce_tpu_torch.models.hidream import HiDreamConfig
from uce_tpu_torch.models.llama import LlamaConfig
from uce_tpu_torch.models.t5 import T5Config
from uce_tpu_torch.ops.quant import QKEY, WKEY


def _quant_kind(v) -> str | None:
    if isinstance(v, Mapping):
        return next((k for k in (QKEY, WKEY) if k in v), None)
    return None


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping) and _quant_kind(v) is None:
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _to_port_layout(key: str, v: np.ndarray) -> np.ndarray:
    if key.endswith("weight") and v.ndim == 4:
        return np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
    if key.endswith("weight") and v.ndim == 2:
        return np.swapaxes(v, 0, 1)            # [in, out] -> [out, in]
    return v


def _convert(key: str, v):
    kind = _quant_kind(v)
    if kind is None:
        return torch.tensor(_to_port_layout(key, np.asarray(v, np.float32)))
    payload = np.ascontiguousarray(_to_port_layout(key, np.asarray(v[kind], np.int8)))
    return {kind: torch.from_numpy(payload),
            "scale": torch.tensor(np.asarray(v["scale"], np.float32).reshape(-1))}


def _index(v, i):
    """Layer (or expert) ``i`` of a stacked leaf, quantized or not."""
    if _quant_kind(v) is not None:
        return {k: np.asarray(a)[i] for k, a in v.items()}
    return np.asarray(v)[i]


def nested_to_state_dict(params: Mapping) -> dict:
    """uce_tpu nested UNet or VAE params -> flat diffusers state dict (with
    the port's quantized weights where uce_tpu has quantized leaves)."""
    return {k: _convert(k, v) for k, v in _flatten(params).items()}


def clip_text_params(params: Mapping, config: CLIPTextConfig) -> dict:
    """uce_tpu layer-stacked CLIP text params -> the port's params (with the
    text projection, [in, out] -> [out, in], where there is one)."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    layers = params["layers"]
    out = {
        "token_embedding": t(params["token_embedding"]),
        "position_embedding": t(params["position_embedding"]),
        "final_ln_scale": t(params["final_ln_scale"]),
        "final_ln_bias": t(params["final_ln_bias"]),
        "layers": [],
    }
    for i in range(config.num_hidden_layers):
        layer = {}
        for name in _LAYER_KEYS:
            v = np.asarray(layers[name][i], np.float32)
            layer[name] = t(v.T if name.endswith("_w") else v)
        out["layers"].append(layer)
    if "text_projection" in params:
        out["text_projection"] = t(np.asarray(params["text_projection"], np.float32).T)
    return out


def flux_params(params: Mapping, config: FluxConfig) -> dict:
    """uce_tpu's FLUX DiT params (both block families layer-stacked) -> the
    port's flat diffusers state dict."""
    stacked = {"transformer_blocks": config.num_layers,
               "single_transformer_blocks": config.num_single_layers}
    out = {}
    for key, v in _flatten(params).items():
        family, _, rest = key.partition(".")
        if family in stacked:
            for i in range(stacked[family]):
                name = f"{family}.{i}.{rest}"
                out[name] = _convert(name, _index(v, i))
        else:
            out[key] = _convert(key, v)
    return out


def _text_encoder(params: Mapping, n_layers: int) -> dict:
    """A layer-stacked text encoder of uce_tpu (linear weights [L, in, out],
    norm scales [L, D]) -> the port's per-layer list, HF layouts."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    return {
        "token_embedding": t(params["token_embedding"]),
        "layers": [{name: t(np.asarray(v[i]).T if np.asarray(v).ndim == 3 else v[i])
                    for name, v in params["layers"].items()}
                   for i in range(n_layers)],
        "final_ln": t(params["final_ln"]),
    }


def t5_params(params: Mapping, config: T5Config) -> dict:
    """uce_tpu's layer-stacked T5 params ([in, out], rel_bias [heads,
    buckets]) -> the port's (HF layouts)."""
    return {**_text_encoder(params, config.num_layers),
            "rel_bias": torch.tensor(np.asarray(params["rel_bias"], np.float32).T)}


def llama_params(params: Mapping, config: LlamaConfig) -> dict:
    """uce_tpu's layer-stacked Llama params ([in, out]) -> the port's (HF
    layouts)."""
    return _text_encoder(params, config.num_hidden_layers)


def hidream_params(params: Mapping, config: HiDreamConfig) -> dict:
    """uce_tpu's HiDream DiT params (both block families layer-stacked, the
    routed experts as [L, E, in, out], the Llama caption projections as one
    [n, in, out] bank) -> the port's flat diffusers state dict. The MoE
    gate stays [E, D], as diffusers stores it."""
    stacked = {"double_stream_blocks": config.num_layers,
               "single_stream_blocks": config.num_single_layers}
    out = {}
    for key, v in _flatten(params).items():
        family, _, rest = key.partition(".")
        if family == "caption_projection":
            if rest == "llama.weight":
                for i in range(np.asarray(v).shape[0]):
                    out[f"caption_projection.{i}.linear.weight"] = _convert("weight",
                                                                            _index(v, i))
            else:
                n = config.num_caption_projections - 1
                out[f"caption_projection.{n}.linear.weight"] = _convert("weight", v)
        elif family in stacked:
            for i in range(stacked[family]):
                name = f"{family}.{i}.block.{rest}".replace(".ff_i.shared.",
                                                             ".ff_i.shared_experts.")
                expert = re.fullmatch(r"(.*)\.experts\.(w[123])\.weight", name)
                if expert:
                    layer = _index(v, i)
                    for e in range(config.num_routed_experts):
                        out[f"{expert.group(1)}.experts.{e}.{expert.group(2)}.weight"] = \
                            _convert("weight", _index(layer, e))
                elif name.endswith(".gate.weight"):
                    out[name] = torch.tensor(np.asarray(v[i], np.float32))
                else:
                    out[name] = _convert(name, _index(v, i))
        else:
            out[key] = _convert(key, v)
    return out


def _vision_tree(tree: Mapping) -> dict:
    """A uce_tpu vision-backbone tree (conv kernels HWIO, the fc weight [in,
    out], vectors) -> the port's nested params (OIHW, [out, in]), same keys:
    ``models/vision_backbones.py``'s AlexNet, VGG19 and ResNet-50 params."""
    return {k: (_vision_tree(v) if isinstance(v, Mapping) else
                torch.tensor(_to_port_layout("weight", np.asarray(v, np.float32))))
            for k, v in tree.items()}


alexnet_params = vgg19_params = resnet50_params = _vision_tree
