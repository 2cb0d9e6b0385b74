"""SD / SDXL closed-form concept erasure (reference: trainscripts/uce_sd_erase.py).

  1. select the UNet cross-attention to_k/to_v weights straight from the
     safetensors state dict,
  2. encode every unique concept in one batched CLIP forward (SDXL: both
     encoders, their penultimate states concatenated),
  3. collapse the multi-layer Eq.-7 solve into one d x d edit matrix and
     apply it to all layers with one stacked matmul (``method="collapsed"``
     by Cholesky, ``"pallas"`` by the Newton-Schulz kernel of
     ``ops/kernels/uce_solve.py``, which takes d <= MAX_PALLAS_DIM: above
     it, SDXL's d=2048, the collapsed solve runs with a warning, as in
     uce_tpu), or solve per layer with batched right-hand sides
     (``"general"``); the results agree to fp32 round-off,
  4. export safetensors with '<module>.weight' keys, loadable by diffusers
     with load_state_dict(strict=False).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Mapping, Sequence

import torch

from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.models import clip_text, sd_targets
from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, save_safetensors
from uce_tpu_torch.ops.kernels.uce_solve import MAX_PALLAS_DIM, uce_edit_matrix_pallas
from uce_tpu_torch.ops.solver import (
    apply_edit_matrix,
    full_fp32,
    uce_edit_matrix,
    uce_solve_stacked,
)

logger = logging.getLogger(__name__)

METHODS = ("collapsed", "general", "pallas")
APPLY_ON = ("device", "host")
FAMILIES = ("sd", "sdxl")


@dataclasses.dataclass
class SDEditResources:
    """Everything a text-space edit of an SD v1.x/v2.x or SDXL UNet needs."""

    targets: dict[str, torch.Tensor]  # {module.weight: [out, d]} fp32
    text_params: dict
    text_config: clip_text.CLIPTextConfig
    tokenizer: CLIPTokenizer
    device: torch.device
    # SDXL's second encoder (None for SD v1/v2)
    text_params_2: dict | None = None
    text_config_2: clip_text.CLIPTextConfig | None = None
    tokenizer_2: CLIPTokenizer | None = None

    def encode_concepts(self, concepts: Sequence[str]) -> dict[str, torch.Tensor]:
        if self.text_params_2 is not None:
            return emb.encode_concepts_sdxl(
                self.text_params, self.text_config, self.tokenizer,
                self.text_params_2, self.text_config_2, self.tokenizer_2,
                concepts, self.device)
        return emb.encode_concepts_sd(self.text_params, self.text_config,
                                      self.tokenizer, concepts, self.device)


def load_tokenizer(model_dir: str, subfolder: str = "tokenizer") -> CLIPTokenizer:
    """A CLIP tokenizer directory (``vocab.json`` + ``merges.txt``); T5 and
    Llama directories go through ``models.hf_tokenizer.load_tokenizer_dir``."""
    return CLIPTokenizer.from_pretrained(os.path.join(model_dir, subfolder))


def load_text_encoder(model_dir: str, subfolder: str = "text_encoder",
                      device="cuda"):
    config = clip_text.CLIPTextConfig.from_hf(
        load_json(os.path.join(model_dir, subfolder, "config.json")))
    sd = {k: v.to(device) for k, v in
          load_state_dict(model_dir, subfolder, dtype=torch.float32).items()}
    return clip_text.convert_hf_state_dict(sd, config), config


def load_resources(model_dir: str, family: str = "sd",
                   device="cuda") -> SDEditResources:
    """Edit targets + text encoder(s) from an HF snapshot directory; SDXL
    (``family="sdxl"``) also loads ``text_encoder_2`` and ``tokenizer_2``."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family: {family!r} (one of {FAMILIES})")
    device = torch.device(device)
    unet_sd = load_state_dict(model_dir, "unet", keys=sd_targets.is_sd_cross_attn_kv,
                              dtype=torch.float32)
    targets = sd_targets.select_targets(unet_sd, family)
    params, config = load_text_encoder(model_dir, device=device)
    res = SDEditResources(targets=targets, text_params=params, text_config=config,
                          tokenizer=load_tokenizer(model_dir), device=device)
    if family == "sdxl":
        res.text_params_2, res.text_config_2 = load_text_encoder(
            model_dir, "text_encoder_2", device=device)
        res.tokenizer_2 = load_tokenizer(model_dir, "tokenizer_2")
    return res


def erase_from_embeddings(
    targets: Mapping[str, torch.Tensor],
    concept_embeds: Mapping[str, torch.Tensor],
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    device="cuda",
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
    if method == "pallas" and c_edit.shape[1] > MAX_PALLAS_DIM:
        # uce_tpu's documented rule (uce_tpu/edit/sd.py): the kernel takes
        # d <= MAX_PALLAS_DIM; SDXL's d=2048 takes the collapsed solve
        logger.warning("pallas edit kernel needs d <= %d (got d=%d); using the "
                       "collapsed solve", MAX_PALLAS_DIM, c_edit.shape[1])
        solve = uce_edit_matrix
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
