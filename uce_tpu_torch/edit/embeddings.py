"""Concept embeddings: every unique concept tokenized into one [N, T] batch,
encoded in one CLIP forward (one per encoder for SDXL), and its last real
token gathered."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from uce_tpu_torch.models import clip_text


def tokenize_batch(tokenizer, prompts: Sequence[str], max_length: int):
    """Fixed-shape numpy (input_ids, attention_mask), HF call signature."""
    enc = tokenizer(list(prompts), padding="max_length", max_length=max_length,
                    truncation=True, return_tensors="np")
    return (np.asarray(enc["input_ids"], np.int64),
            np.asarray(enc["attention_mask"], np.int64))


def last_token_indices(attention_mask: np.ndarray) -> np.ndarray:
    """Reference rule: the last real (non-eos, non-pad) token sits at
    attention_mask.sum() - 2."""
    return attention_mask.sum(axis=-1) - 2


def gather_last_tokens(hidden: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """[B, T, D] -> [B, D] at per-row indices."""
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return hidden[rows, torch.as_tensor(idx, device=hidden.device)]


def encode_concepts_sd(params: dict, config: clip_text.CLIPTextConfig,
                       tokenizer, concepts: Sequence[str], device="cuda"
                       ) -> dict[str, torch.Tensor]:
    """SD v1.x/v2.x: {concept: [d] fp32 last-real-token hidden state}."""
    unique = list(dict.fromkeys(concepts))
    ids, mask = tokenize_batch(tokenizer, unique, config.max_position_embeddings)
    last_hidden, _, _ = clip_text.encode_tokens(
        params, torch.as_tensor(ids, device=device), config)
    embeds = gather_last_tokens(last_hidden, last_token_indices(mask)).float()
    return dict(zip(unique, embeds))


def encode_concepts_sdxl(params_1: dict, config_1: clip_text.CLIPTextConfig,
                         tokenizer_1, params_2: dict,
                         config_2: clip_text.CLIPTextConfig, tokenizer_2,
                         concepts: Sequence[str], device="cuda"
                         ) -> dict[str, torch.Tensor]:
    """SDXL: {concept: [d1 + d2] fp32}, both encoders' penultimate hidden
    states (diffusers' encode_prompt, clip_skip=None: hidden_states[-2])
    concatenated, at the last real token of tokenizer_1's mask."""
    unique = list(dict.fromkeys(concepts))
    parts, mask_1 = [], None
    for params, config, tokenizer in ((params_1, config_1, tokenizer_1),
                                      (params_2, config_2, tokenizer_2)):
        ids, mask = tokenize_batch(tokenizer, unique, config.max_position_embeddings)
        mask_1 = mask if mask_1 is None else mask_1
        _, _, hiddens = clip_text.encode_tokens(
            params, torch.as_tensor(ids, device=device), config,
            output_hidden_states=True)
        parts.append(hiddens[-2])  # layer L-1's output, no final LN
    if parts[0].shape[1] != parts[1].shape[1]:
        raise ValueError("SDXL encoders must share sequence length")
    joint = torch.cat(parts, dim=-1)
    embeds = gather_last_tokens(joint, last_token_indices(mask_1)).float()
    return dict(zip(unique, embeds))


def stack_embeds(embeds: Mapping[str, torch.Tensor], concepts: Sequence[str],
                 device="cuda") -> torch.Tensor:
    """[K, d] stack in concept order (repeats as listed)."""
    if not concepts:
        d = len(next(iter(embeds.values()))) if embeds else 0
        return torch.zeros((0, d), dtype=torch.float32, device=device)
    return torch.stack([embeds[c].float().to(device) for c in concepts])
