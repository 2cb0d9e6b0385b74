"""Param quantization pass over the port's flat state dicts: eligible float
weights become the int8 dicts of ``ops/quant.py`` (uce_tpu/models/quantize.py,
SD branch).

Eligible = a floating ``weight`` of 2 dims or more none of whose key
components contains a skip token: a token matches a component as a
substring, so ``time_emb`` also skips ``time_emb_proj`` and ``quant_conv``
also skips ``post_quant_conv``. The skips keep the network's ends and its
conditioning in float. The depth-stacked DiT branch (FLUX/HiDream skips,
per-layer scales) comes with those models.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from uce_tpu_torch.ops import quant

UNET_SKIP = ("conv_in", "conv_out", "time_emb", "add_embedding", "norm")
VAE_SKIP = ("conv_in", "conv_out", "norm", "quant_conv")
MODES = ("int8", "w8")


def _skipped(parts, skip) -> bool:
    return any(tok in p for tok in skip for p in parts)


def _is_quant(v) -> bool:
    return quant.is_quantized(v) or quant.is_weight_only(v)


def quantize_params(params: Mapping, skip: Iterable[str] = UNET_SKIP,
                    mode: str = "int8") -> dict:
    """A copy of ``params`` with eligible weights quantized: ``"int8"`` =
    W8A8, ``"w8"`` = weight-only int8."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")
    skip = tuple(skip)
    out = {}
    for key, v in params.items():
        parts = key.split(".")
        if (parts[-1] == "weight" and isinstance(v, torch.Tensor) and v.ndim >= 2
                and v.is_floating_point() and not _skipped(parts, skip)):
            v = quant.quantize_weight(v, weight_only=mode == "w8")
        out[key] = v
    return out


def count_quantized(params: Mapping) -> tuple[int, int]:
    """(quantized weights, weights of 2 dims or more)."""
    nq = sum(_is_quant(v) for v in params.values())
    nw = sum(k.rpartition(".")[2] == "weight" and (_is_quant(v) or v.ndim >= 2)
             for k, v in params.items())
    return nq, nw
