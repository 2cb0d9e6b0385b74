"""SD closed-form concept erasure (reference: trainscripts/uce_sd_erase.py).

  1. select the UNet cross-attention to_k/to_v weights straight from the
     safetensors state dict,
  2. encode every unique concept in one batched CLIP forward,
  3. collapse the multi-layer Eq.-7 solve into one d x d edit matrix and
     apply it to all layers with one stacked matmul (``method="collapsed"``
     by Cholesky, ``"pallas"`` by the Newton-Schulz kernel of
     ``ops/kernels/uce_solve.py``), or solve per layer with batched
     right-hand sides (``"general"``); the results agree to fp32 round-off,
  4. export safetensors with '<module>.weight' keys, loadable by diffusers
     with load_state_dict(strict=False).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Mapping, Sequence

import torch

from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.models import clip_text, sd_targets
from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, save_safetensors
from uce_tpu_torch.ops.kernels.uce_solve import uce_edit_matrix_pallas
from uce_tpu_torch.ops.solver import (
    apply_edit_matrix,
    full_fp32,
    uce_edit_matrix,
    uce_solve_stacked,
)

METHODS = ("collapsed", "general", "pallas")
APPLY_ON = ("device", "host")


@dataclasses.dataclass
class SDEditResources:
    """Everything a text-space edit of an SD v1.x UNet needs."""

    targets: dict[str, torch.Tensor]  # {module.weight: [out, d]} fp32
    text_params: dict
    text_config: clip_text.CLIPTextConfig
    tokenizer: CLIPTokenizer
    device: torch.device

    def encode_concepts(self, concepts: Sequence[str]) -> dict[str, torch.Tensor]:
        return emb.encode_concepts_sd(self.text_params, self.text_config,
                                      self.tokenizer, concepts, self.device)


def load_tokenizer(model_dir: str, subfolder: str = "tokenizer") -> CLIPTokenizer:
    return CLIPTokenizer.from_pretrained(os.path.join(model_dir, subfolder))


def load_text_encoder(model_dir: str, subfolder: str = "text_encoder",
                      device="cpu"):
    config = clip_text.CLIPTextConfig.from_hf(
        load_json(os.path.join(model_dir, subfolder, "config.json")))
    sd = {k: v.to(device) for k, v in
          load_state_dict(model_dir, subfolder, dtype=torch.float32).items()}
    return clip_text.convert_hf_state_dict(sd, config), config


def load_resources(model_dir: str, device="cpu") -> SDEditResources:
    """Edit targets + text encoder from an HF snapshot directory."""
    device = torch.device(device)
    unet_sd = load_state_dict(model_dir, "unet", keys=sd_targets.is_sd_cross_attn_kv,
                              dtype=torch.float32)
    targets = sd_targets.select_targets(unet_sd, "sd")
    params, config = load_text_encoder(model_dir, device=device)
    return SDEditResources(targets=targets, text_params=params, text_config=config,
                           tokenizer=load_tokenizer(model_dir), device=device)


def erase_from_embeddings(
    targets: Mapping[str, torch.Tensor],
    concept_embeds: Mapping[str, torch.Tensor],
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    device="cpu",
    method: str = "collapsed",
    apply_on: str = "device",
) -> dict[str, torch.Tensor]:
    """Solve the edit from precomputed concept embeddings; returns the
    edited weights as fp32 CPU tensors in the targets' key order.

    Guide outputs are the original module outputs of the guide concepts
    (W_old @ c_guide), which makes the collapsed edit matrix exact.
    ``apply_on`` says where the collapsed W @ E multiply runs: on ``device``
    or, for ``host``, on the CPU after E alone comes back."""
    if method not in METHODS:
        raise ValueError(f"unknown method: {method!r} (one of {METHODS})")
    if apply_on not in APPLY_ON:
        raise ValueError(f"unknown apply_on: {apply_on!r} (one of {APPLY_ON})")
    c_edit = emb.stack_embeds(concept_embeds, edit_concepts, device)
    c_guide = emb.stack_embeds(concept_embeds, guide_concepts, device)
    c_pres = emb.stack_embeds(concept_embeds, preserve_concepts, device)
    if c_pres.shape[0] == 0:
        c_pres = torch.zeros((0, c_edit.shape[1]), device=device)

    if method == "general":
        out = {}
        for group in _group_by_shape(targets).values():
            names = list(group)
            w_stack = torch.stack([group[n].float().to(device) for n in names])
            with full_fp32():
                v_guide = torch.einsum("kd,lod->lko", c_guide, w_stack)
            new = uce_solve_stacked(w_stack, c_edit, v_guide, c_pres,
                                    erase_scale=erase_scale,
                                    preserve_scale=preserve_scale, lamb=lamb)
            out.update(zip(names, new.cpu()))
        return {n: out[n] for n in targets}

    solve = uce_edit_matrix_pallas if method == "pallas" else uce_edit_matrix
    e_mat = solve(c_edit, c_guide, c_pres, erase_scale, preserve_scale, lamb)
    names = list(targets)
    w_cat = torch.cat([targets[n].float() for n in names])
    if apply_on == "host":
        new_cat = apply_edit_matrix(w_cat.cpu(), e_mat.cpu())
    else:
        new_cat = apply_edit_matrix(w_cat.to(device), e_mat).cpu()
    out, off = {}, 0
    for n in names:
        rows = targets[n].shape[0]
        out[n] = new_cat[off:off + rows]
        off += rows
    return out


def _group_by_shape(targets: Mapping[str, torch.Tensor]):
    groups: dict[tuple, dict] = {}
    for k, v in targets.items():
        groups.setdefault(tuple(v.shape), {})[k] = v
    return groups


def run_erase(
    resources: SDEditResources,
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    save_dir: str | None = None,
    exp_name: str = "uce_test",
    method: str = "collapsed",
    apply_on: str = "device",
) -> dict[str, torch.Tensor]:
    """Full erase: encode -> solve -> (optionally) export safetensors."""
    start = time.time()
    concepts = list(edit_concepts) + list(guide_concepts) + list(preserve_concepts)
    concept_embeds = resources.encode_concepts(concepts)
    edited = erase_from_embeddings(
        resources.targets, concept_embeds, edit_concepts, guide_concepts,
        preserve_concepts, erase_scale, preserve_scale, lamb, resources.device,
        method, apply_on)
    if save_dir is not None:
        save_safetensors(edited, os.path.join(save_dir, exp_name + ".safetensors"))
    elapsed = time.time() - start
    print(f"\n\nErased concepts using UCE\nModel edited in {elapsed} seconds\n")
    return edited
