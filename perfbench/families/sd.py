"""Stable Diffusion v1: the port's ``SDPipeline`` built from the benchmark's
weights and tokenizer files, with the configuration's UCE erase solved
through ``edit/sd.py`` (collapsed) and overlaid as ``generate
--uce_model_path`` overlays it; and the reference's answers."""

from __future__ import annotations

import os
import time

import torch

from perfbench.core import vocab
from perfbench.reference import generate as ref


def build(cfg, seed, device, workdir, phases: dict) -> dict:
    """The edited pipeline; ``phases`` gets the seconds of each step."""
    mark = time.perf_counter()
    from uce_tpu_torch.diffusion.pipeline import SDPipeline
    from uce_tpu_torch.edit import sd as edit_sd
    from uce_tpu_torch.models import clip_text, sd_targets, unet, vae
    from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from uce_tpu_torch.models.hf_loader import save_safetensors

    phases["imports"] = time.perf_counter() - mark
    mark = time.perf_counter()
    w = ref.sd_weights(cfg, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights"] = time.perf_counter() - mark
    mark = time.perf_counter()
    tcfg = clip_text.CLIPTextConfig.from_hf(cfg["text_encoder"])
    text = clip_text.convert_hf_state_dict(w["text"], tcfg)
    tokenizer = CLIPTokenizer.from_pretrained(vocab.write_clip(os.path.join(workdir, "clip")))
    pipe = SDPipeline(unet_params=w["unet"], unet_config=unet.UNetConfig.from_hf(cfg["unet"]),
                      text_params=text, text_config=tcfg, tokenizer=tokenizer,
                      vae_params=w["vae"], vae_config=vae.VAEConfig.from_hf(cfg["vae"]),
                      scheduler_config=cfg["scheduler"], dtype=getattr(torch, cfg["dtype"]),
                      device=torch.device(device))
    phases["pipeline"] = time.perf_counter() - mark
    mark = time.perf_counter()
    edit = cfg["edit"]
    targets = sd_targets.select_targets(
        {k: v.float().cpu() for k, v in w["unet"].items() if sd_targets.is_sd_cross_attn_kv(k)},
        "sd")
    res = edit_sd.SDEditResources(targets=targets, text_params=text, text_config=tcfg,
                                  tokenizer=tokenizer, device=torch.device(device))
    edited = edit_sd.run_erase(res, edit["erase"], edit["guide"], edit["preserve"],
                               lamb=edit["lamb"], method="collapsed")
    path = os.path.join(workdir, "uce_edit.safetensors")
    save_safetensors(edited, path)
    pipe.load_uce_edits(path)
    phases["edit"] = time.perf_counter() - mark
    return {"pipe": pipe}


def pipeline(system):
    return system["pipe"]


def generate(system, rows, traffic) -> object:
    """One eval-protocol call: uint8 images [rows x samples, H, W, 3]."""
    return system["pipe"]([p for p, _ in rows], num_inference_steps=traffic["steps"],
                          guidance_scale=traffic["guidance"],
                          num_images_per_prompt=traffic["samples"],
                          seed=[s for _, s in rows], height=traffic["size"],
                          width=traffic["size"], scheduler=traffic.get("scheduler"))


def control(system) -> None:
    """The correctness check's control: the port's own W8A8 path (``--quantize int8``)."""
    system["pipe"].quantize_weights("int8")


def free(system) -> None:
    system.clear()


def reference(cfg, traffic, seed, jobs, device, workdir):
    w = ref.sd_weights(cfg, seed, device)
    vocab_map = vocab.clip_vocab()
    return ref.sd_images(cfg, traffic, w, vocab_map, jobs, device)


def work(cfg, traffic) -> list:
    return ref.sd_work(cfg, traffic)
