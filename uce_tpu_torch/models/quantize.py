"""Param quantization pass over the port's flat state dicts: eligible float
weights become the int8 dicts of ``ops/quant.py`` (uce_tpu/models/quantize.py).

Eligible = a floating ``weight`` of 2 dims or more that no skip token
selects. A string token matches a key component as a substring, so
``time_emb`` also skips ``time_emb_proj`` and ``quant_conv`` also skips
``post_quant_conv``; a tuple token is a root-anchored prefix of the key's
components, so FLUX's ``("proj_out",)`` skips the final ``proj_out.weight``
and not ``single_transformer_blocks.N.proj_out.weight``. The skips keep the
network's ends, its conditioning, the UCE edit targets and HiDream's MoE
router in float.

uce_tpu's DiT trees are depth-stacked (``[L, in, out]`` leaves, the routed
experts ``[L, E, in, out]``) and quantized with one scale row per layer and
expert; the port's flat diffusers keys hold one layer (and one expert) each,
so a per-key scale is the same thing: the int8 payloads and fp32 scales
equal uce_tpu's, transposed to ``[out, in]``. The skip tokens select the
same weights under both naming schemes (``tests/test_torch_quant.py``).
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import torch

from uce_tpu_torch.ops import quant

UNET_SKIP = ("conv_in", "conv_out", "time_emb", "add_embedding", "norm")
VAE_SKIP = ("conv_in", "conv_out", "norm", "quant_conv")
# FLUX DiT: the entry, exit and conditioning projections (x_embedder, the
# final proj_out and its AdaLN norm_out, the time/text MLPs) and the UCE edit
# targets (context_embedder, time_text_embed.text_embedder.linear_1), kept
# float so edit overlays apply exactly. The blocks' AdaLN linears are
# quantized.
FLUX_SKIP = ("x_embedder", "context_embedder", "time_text_embed",
             "norm_out", ("proj_out",))
# HiDream-I1 MoE DiT: entry, exit and conditioning, the MoE router
# (``ff_i.gate``) and the caption projections (the UCE edit targets).
HIDREAM_SKIP = ("x_embedder", "t_embedder", "p_embedder",
                "caption_projection", "final_layer", "gate")
MODES = ("int8", "w8")


def _skipped(parts, skip) -> bool:
    for tok in skip:
        if isinstance(tok, tuple):
            if tuple(parts[:len(tok)]) == tok:
                return True
        elif any(tok in p for p in parts):
            return True
    return False


def _is_quant(v) -> bool:
    return quant.is_quantized(v) or quant.is_weight_only(v)


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    return mode


def quantizer(skip: Iterable = UNET_SKIP, mode: str = "int8") -> Callable:
    """``fn(key, value)``: the value quantized where it is eligible, else as
    it is; for a loader that quantizes each tensor as it is read."""
    check_mode(mode)
    skip = tuple(skip)

    def fn(key: str, v):
        parts = key.split(".")
        if (parts[-1] == "weight" and isinstance(v, torch.Tensor) and v.ndim >= 2
                and v.is_floating_point() and not _skipped(parts, skip)):
            return quant.quantize_weight(v, weight_only=mode == "w8")
        return v

    return fn


def quantize_params(params: Mapping, skip: Iterable = UNET_SKIP,
                    mode: str = "int8") -> dict:
    """A copy of ``params`` with eligible weights quantized: ``"int8"`` =
    W8A8, ``"w8"`` = weight-only int8."""
    fn = quantizer(skip, mode)
    return {key: fn(key, v) for key, v in params.items()}


def count_quantized(params: Mapping) -> tuple[int, int]:
    """(quantized weights, weights of 2 dims or more)."""
    nq = sum(_is_quant(v) for v in params.values())
    nw = sum(k.rpartition(".")[2] == "weight" and (_is_quant(v) or v.ndim >= 2)
             for k, v in params.items())
    return nq, nw
