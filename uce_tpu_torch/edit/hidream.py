"""HiDream-I1 closed-form edit (reference: trainscripts/uce_hidream_edit.py),
as ``uce_tpu/edit/hidream.py`` makes it.

The targets are the DiT's ``caption_projection.<i>.linear`` matrices. Each
sees its own text stream: projection i < L the Llama-3.1 hidden state at
``llama_layers[i]`` (``uce_hidream_edit.py:39,72-91``), the last one the T5
embedding (``:109-123``). Every projection is solved once with its own
stream's embeddings (the reference's loop re-processes the last module;
uce_tpu solves the intent, SURVEY.md §2.1), so the edit is one batched
per-module solve, ``ops/solver.py::uce_edit_matrix_batch``. Only the
targets are read out of the transformer's files; the DiT is never loaded.
Export keys are '<module>.weight' safetensors entries.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Mapping, Sequence

import torch

from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.edit.flux import load_t5_encoder, load_t5_tokenizer
from uce_tpu_torch.models import llama as llama_mod, sd_targets, t5 as t5_mod
from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from uce_tpu_torch.models.hf_tokenizer import HFTokenizer, load_tokenizer_dir
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, save_safetensors
from uce_tpu_torch.ops.solver import apply_edit_matrix, uce_edit_matrix_batch

DEFAULT_LLAMA_ID = "meta-llama/Meta-Llama-3.1-8B-Instruct"


def module_index(key: str) -> int:
    m = re.search(r"caption_projection\.(\d+)\.", key)
    if m is None:
        raise ValueError(f"cannot parse caption_projection index from {key}")
    return int(m.group(1))


@dataclasses.dataclass
class HiDreamEditResources:
    targets: dict[str, torch.Tensor]  # fp32 on the host, by caption_projection index
    llama_layers: Sequence[int]
    llama_params: dict
    llama_config: llama_mod.LlamaConfig
    llama_tokenizer: CLIPTokenizer | HFTokenizer
    t5_params: dict
    t5_config: t5_mod.T5Config
    t5_tokenizer: CLIPTokenizer | HFTokenizer
    max_sequence_length: int = 128
    device: torch.device = torch.device("cuda")


def resolve_llama_dir(model_dir: str, llama_dir: str | None) -> str:
    """The Llama-3.1 encoder's directory: ``llama_dir``, else the snapshot's
    own ``text_encoder_4``."""
    if llama_dir is not None:
        return llama_dir
    cand = os.path.join(model_dir, "text_encoder_4")
    if os.path.isdir(cand):
        return cand
    raise ValueError(
        "HiDream needs the Llama-3.1 encoder: pass llama_dir (a local snapshot of "
        f"{DEFAULT_LLAMA_ID}), or give the snapshot a text_encoder_4")


def load_llama_encoder(llama_dir: str, device="cuda"):
    """(params, config) of a Llama snapshot without its LM head, fp32 on
    ``device``."""
    config = llama_mod.LlamaConfig.from_hf(load_json(os.path.join(llama_dir, "config.json")))
    sd = load_state_dict(llama_dir, None, keys=lambda k: not k.startswith("lm_head"),
                         dtype=torch.float32, device=device)
    return llama_mod.convert_hf_state_dict(sd, config), config


def load_llama_tokenizer(path: str):
    """The Llama-3.1 tokenizer, padding with eos where the files name no
    pad token, as diffusers' HiDreamImagePipeline does."""
    return load_tokenizer_dir(path, "Llama", pad_to_eos=True)


def load_resources(model_dir: str, llama_dir: str | None = None,
                   max_sequence_length: int = 128, device="cuda") -> HiDreamEditResources:
    """The caption-projection targets (fp32, on the host, ordered by index),
    the Llama and T5 encoders (fp32 on ``device``) and their tokenizers."""
    device = torch.device(device)
    llama_dir = resolve_llama_dir(model_dir, llama_dir)
    targets = load_state_dict(model_dir, "transformer",
                              keys=sd_targets.is_hidream_caption_projection,
                              dtype=torch.float32)
    targets = dict(sorted(targets.items(), key=lambda kv: module_index(kv[0])))
    tr_cfg = load_json(os.path.join(model_dir, "transformer", "config.json"))
    llama_params, llama_cfg = load_llama_encoder(llama_dir, device)
    t5_params, t5_cfg = load_t5_encoder(model_dir, device, "text_encoder_3")
    return HiDreamEditResources(
        targets=targets, llama_layers=tr_cfg["llama_layers"], llama_params=llama_params,
        llama_config=llama_cfg, llama_tokenizer=load_llama_tokenizer(llama_dir),
        t5_params=t5_params, t5_config=t5_cfg,
        t5_tokenizer=load_t5_tokenizer(model_dir, "tokenizer_3"),
        max_sequence_length=max_sequence_length, device=device)


@torch.inference_mode()
def encode_concepts(res: HiDreamEditResources,
                    concepts: Sequence[str]) -> dict[str, list[torch.Tensor]]:
    """{concept: [llama stream 0, ..., llama stream L-1, t5]} fp32 embeddings
    of the last real token (attention_mask.sum() - 2,
    uce_hidream_edit.py:78-88, 114-122): Llama's hidden_states[1:] indexed
    by llama_layers, then T5's last hidden state (run under its mask)."""
    unique = list(dict.fromkeys(concepts))
    ids, mask = emb.tokenize_batch(res.llama_tokenizer, unique, res.max_sequence_length)
    hidden = llama_mod.encode_tokens(res.llama_params,
                                     torch.as_tensor(ids, device=res.device),
                                     torch.as_tensor(mask, device=res.device),
                                     res.llama_config)
    rows = torch.arange(len(unique), device=res.device)
    idx = torch.as_tensor(emb.last_token_indices(mask), device=res.device)
    llama_embeds = hidden[1:, rows, idx].float()  # [L_all, N, d]
    del hidden
    ids_t, mask_t = emb.tokenize_batch(res.t5_tokenizer, unique, res.max_sequence_length)
    t5_hidden = t5_mod.encode_tokens(res.t5_params, torch.as_tensor(ids_t, device=res.device),
                                     torch.as_tensor(mask_t, device=res.device),
                                     res.t5_config)
    t5_embeds = emb.gather_last_tokens(t5_hidden, emb.last_token_indices(mask_t)).float()
    return {c: [llama_embeds[li, i] for li in res.llama_layers] + [t5_embeds[i]]
            for i, c in enumerate(unique)}


def erase_from_embeddings(
    targets: Mapping[str, torch.Tensor],
    concept_embeds: Mapping[str, Sequence[torch.Tensor]],
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    device="cuda",
) -> dict[str, torch.Tensor]:
    """One batched solve over the modules, module i with stream i; the
    edited weights as fp32 CPU tensors in the targets' order."""
    names = list(targets)
    n_streams = len(next(iter(concept_embeds.values())))
    if len(names) != n_streams:
        raise ValueError(f"{len(names)} caption projections but {n_streams} embedding "
                         "streams (llama_layers + t5): snapshot/config mismatch")

    def stack(cs):  # [M, K, d]
        if not cs:
            d = len(next(iter(concept_embeds.values()))[0])
            return torch.zeros((len(names), 0, d), dtype=torch.float32, device=device)
        return torch.stack([torch.stack([concept_embeds[c][m].float().to(device)
                                         for c in cs]) for m in range(len(names))])

    e_mats = uce_edit_matrix_batch(stack(edit_concepts), stack(guide_concepts),
                                   stack(preserve_concepts), erase_scale, preserve_scale,
                                   lamb)
    return {name: apply_edit_matrix(targets[name].float().to(device), e_mats[m]).cpu()
            for m, name in enumerate(names)}


def run_erase(
    resources: HiDreamEditResources,
    edit_concepts: Sequence[str],
    guide_concepts: Sequence[str],
    preserve_concepts: Sequence[str],
    erase_scale: float = 1.0,
    preserve_scale: float = 1.0,
    lamb: float = 0.5,
    save_dir: str | None = None,
    exp_name: str = "uce_test",
) -> dict[str, torch.Tensor]:
    """Full erase: encode -> per-module batched solve -> (optionally)
    safetensors."""
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
