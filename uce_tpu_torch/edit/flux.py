"""FLUX.1 (dev / schnell) closed-form edit (reference:
trainscripts/uce_flux_edit.py), as ``uce_tpu/edit/flux.py`` makes it.

FLUX's text-entry projections are edited instead of cross-attention:
  * ``context_embedder``                       (T5-XXL stream, in=4096)
  * ``time_text_embed.text_embedder.linear_1`` (pooled CLIP stream, in=768)

Each concept carries a pair of embeddings [T5 last token, pooled CLIP]
(``uce_flux_edit.py:44-65``); the solver picks the stream by the weight's
input dimension (``:93-95``), here one collapsed solve per input-dim group.
Only the two target tensors are read out of the transformer's files; the
DiT is never loaded. Export keys are '<module>.weight' safetensors entries.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping, Sequence

import torch

from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.edit.sd import load_text_encoder, load_tokenizer
from uce_tpu_torch.models import clip_text, sd_targets, t5 as t5_mod
from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from uce_tpu_torch.models.hf_tokenizer import HFTokenizer, load_tokenizer_dir
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, save_safetensors
from uce_tpu_torch.ops.solver import apply_edit_matrix, uce_edit_matrix


@dataclasses.dataclass
class FluxEditResources:
    targets: dict[str, torch.Tensor]  # {module.weight: [out, d]} fp32
    t5_params: dict
    t5_config: t5_mod.T5Config
    t5_tokenizer: CLIPTokenizer | HFTokenizer
    clip_params: dict
    clip_config: clip_text.CLIPTextConfig
    clip_tokenizer: CLIPTokenizer
    max_sequence_length: int = 512
    device: torch.device = torch.device("cuda")


def default_max_sequence_length(model_id: str) -> int:
    """Reference rule (uce_flux_edit.py:163-165): 256 for schnell, 512 else.

    A local snapshot directory is classified by its transformer config
    (``guidance_embeds`` is False for schnell, True for dev), so a directory
    whose name lacks 'schnell' still gets the right truncation; the name
    rule is the fallback."""
    cfg_path = os.path.join(model_id, "transformer", "config.json")
    if os.path.exists(cfg_path):
        try:
            guidance = load_json(cfg_path).get("guidance_embeds")
        except (OSError, ValueError):
            guidance = None
        if guidance is not None:
            return 256 if guidance is False else 512
    return 256 if "schnell" in model_id else 512


def load_t5_tokenizer(model_dir: str, subfolder: str = "tokenizer_2"):
    """The T5 tokenizer (FLUX's ``tokenizer_2``, HiDream's ``tokenizer_3``)."""
    return load_tokenizer_dir(os.path.join(model_dir, subfolder), "T5")


def load_t5_encoder(model_dir: str, device="cuda", subfolder: str = "text_encoder_2"):
    """(params, config) of a snapshot's T5 encoder (FLUX's text_encoder_2,
    HiDream's text_encoder_3), fp32 on ``device``."""
    config = t5_mod.T5Config.from_hf(
        load_json(os.path.join(model_dir, subfolder, "config.json")))
    sd = load_state_dict(model_dir, subfolder, dtype=torch.float32, device=device)
    return t5_mod.convert_hf_state_dict(sd, config), config


def load_resources(model_dir: str, max_sequence_length: int | None = None,
                   device="cuda") -> FluxEditResources:
    """The two edit targets (fp32, on the host) and both text encoders."""
    device = torch.device(device)
    targets = load_state_dict(model_dir, "transformer", keys=sd_targets.is_flux_text_entry,
                              dtype=torch.float32)
    targets = sd_targets.select_targets(targets, "flux")
    t5_params, t5_cfg = load_t5_encoder(model_dir, device=device)
    clip_params, clip_cfg = load_text_encoder(model_dir, device=device)
    if max_sequence_length is None:
        max_sequence_length = default_max_sequence_length(model_dir)
    return FluxEditResources(
        targets=targets, t5_params=t5_params, t5_config=t5_cfg,
        t5_tokenizer=load_t5_tokenizer(model_dir), clip_params=clip_params,
        clip_config=clip_cfg, clip_tokenizer=load_tokenizer(model_dir),
        max_sequence_length=max_sequence_length, device=device)


@torch.inference_mode()
def encode_concepts(res: FluxEditResources,
                    concepts: Sequence[str]) -> dict[str, dict[int, torch.Tensor]]:
    """{concept: {input_dim: fp32 embedding}} for both text streams.

    T5: the last real token's hidden state (tokenizer_2's mask sum - 2,
    uce_flux_edit.py:55-62), the T5 run with no attention mask as diffusers'
    FluxPipeline runs it (the real mask only indexes). CLIP: the pooled
    output."""
    unique = list(dict.fromkeys(concepts))
    ids, mask = emb.tokenize_batch(res.t5_tokenizer, unique, res.max_sequence_length)
    hidden = t5_mod.encode_tokens(res.t5_params, torch.as_tensor(ids, device=res.device),
                                  None, res.t5_config)
    t5_embeds = emb.gather_last_tokens(hidden, emb.last_token_indices(mask)).float()
    ids_c, _ = emb.tokenize_batch(res.clip_tokenizer, unique,
                                  res.clip_config.max_position_embeddings)
    _, pooled, _ = clip_text.encode_tokens(
        res.clip_params, torch.as_tensor(ids_c, device=res.device), res.clip_config)
    pooled = pooled.float()
    d_t5, d_clip = t5_embeds.shape[-1], pooled.shape[-1]
    if d_t5 == d_clip:
        raise ValueError(
            "T5 and CLIP embedding dims are equal; the input-dim stream dispatch "
            "(uce_flux_edit.py:93-95) is ambiguous for this model")
    return {c: {d_t5: t5_embeds[i], d_clip: pooled[i]} for i, c in enumerate(unique)}


def erase_from_embeddings(
    targets: Mapping[str, torch.Tensor],
    concept_embeds: Mapping[str, Mapping[int, torch.Tensor]],
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """One collapsed solve per input-dim group (the stream is chosen by
    W.shape[-1]); the edited weights as fp32 CPU tensors in the targets'
    order."""
    out: dict[str, torch.Tensor] = {}
    for dim, group in sd_targets.group_by_input_dim(targets).items():
        def stack(cs):
            if not cs:
                return torch.zeros((0, dim), dtype=torch.float32, device=device)
            return torch.stack([concept_embeds[c][dim].float().to(device) for c in cs])

        e_mat = uce_edit_matrix(stack(edit_concepts), stack(guide_concepts),
                                stack(preserve_concepts), erase_scale, preserve_scale,
                                lamb)
        for name, w in group.items():
            out[name] = apply_edit_matrix(w.float().to(device), e_mat).cpu()
    return {n: out[n] for n in targets}


def run_erase(
    resources: FluxEditResources,
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    save_dir: str | None = None,
    exp_name: str = "uce_test",
) -> dict[str, torch.Tensor]:
    """Full erase: encode -> per-stream solve -> (optionally) safetensors."""
    start = time.time()
    concepts = list(edit_concepts) + list(guide_concepts) + list(preserve_concepts)
    concept_embeds = encode_concepts(resources, concepts)
    edited = erase_from_embeddings(
        resources.targets, concept_embeds, edit_concepts, guide_concepts,
        preserve_concepts, erase_scale, preserve_scale, lamb, resources.device)
    if save_dir is not None:
        save_safetensors(edited, os.path.join(save_dir, exp_name + ".safetensors"))
    print(f"\n\nErased concepts using UCE\nModel edited in {time.time() - start} "
          "seconds\n")
    return edited
