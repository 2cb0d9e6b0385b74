"""Concept embeddings: every unique concept tokenized into one [N, T] batch,
encoded in one CLIP forward, and its last real token gathered."""

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
    """SD v1.x: {concept: [d] fp32 last-real-token hidden state}."""
    unique = list(dict.fromkeys(concepts))
    ids, mask = tokenize_batch(tokenizer, unique, config.max_position_embeddings)
    last_hidden, _, _ = clip_text.encode_tokens(
        params, torch.as_tensor(ids, device=device), config)
    embeds = gather_last_tokens(last_hidden, last_token_indices(mask)).float()
    return dict(zip(unique, embeds))


def stack_embeds(embeds: Mapping[str, torch.Tensor], concepts: Sequence[str],
                 device="cuda") -> torch.Tensor:
    """[K, d] stack in concept order (repeats as listed)."""
    if not concepts:
        d = len(next(iter(embeds.values()))) if embeds else 0
        return torch.zeros((0, d), dtype=torch.float32, device=device)
    return torch.stack([embeds[c].float().to(device) for c in concepts])
