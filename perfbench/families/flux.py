"""FLUX.1: the port's ``FluxPipeline`` built from the benchmark's weights
and tokenizer files (handed to its constructor, no snapshot on disk), with
the configuration's UCE erase solved through ``edit/flux.py`` and overlaid
as ``generate-flux --uce_model_path`` overlays it; and the reference's
answers."""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from perfbench.core import vocab, vocab_t5
from perfbench.reference import generate_flux as ref


def build(cfg, seed, device, workdir, phases: dict) -> dict:
    """The edited pipeline; ``phases`` gets the seconds of each step."""
    mark = time.perf_counter()
    from uce_tpu_torch.diffusion.pipeline_flux import FluxPipeline
    from uce_tpu_torch.edit import flux as edit_flux
    from uce_tpu_torch.models import clip_text, flux, sd_targets, t5, vae
    from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from uce_tpu_torch.models.hf_loader import save_safetensors
    from uce_tpu_torch.models.hf_tokenizer import load_tokenizer_dir

    if "use_post_quant_conv" not in {f.name for f in dataclasses.fields(vae.VAEConfig)}:
        raise SystemExit("the program's VAE always applies post_quant_conv: it cannot run "
                         "FLUX.1's VAE, which has none")
    phases["imports"] = time.perf_counter() - mark
    mark = time.perf_counter()
    w = ref.flux_weights(cfg, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    phases["weights"] = time.perf_counter() - mark
    mark = time.perf_counter()
    ccfg = clip_text.CLIPTextConfig.from_hf(cfg["text_encoder"])
    clip = clip_text.convert_hf_state_dict(w["clip"], ccfg)
    tcfg = t5.T5Config.from_hf(cfg["text_encoder_2"])
    t5_params = t5.convert_hf_state_dict(w["t5"], tcfg)
    clip_tok = CLIPTokenizer.from_pretrained(vocab.write_clip(os.path.join(workdir, "clip")))
    t5_tok = load_tokenizer_dir(vocab_t5.write_t5(os.path.join(workdir, "t5")), "T5")
    pipe = FluxPipeline(transformer_params=w["dit"],
                        transformer_config=flux.FluxConfig.from_hf(cfg["transformer"]),
                        t5_params=t5_params, t5_config=tcfg, t5_tokenizer=t5_tok,
                        clip_params=clip, clip_config=ccfg, clip_tokenizer=clip_tok,
                        vae_params=w["vae"], vae_config=vae.VAEConfig.from_hf(cfg["vae"]),
                        scheduler_config=cfg["scheduler"], dtype=getattr(torch, cfg["dtype"]),
                        max_sequence_length=cfg["max_sequence_length"],
                        device=torch.device(device))
    phases["pipeline"] = time.perf_counter() - mark
    mark = time.perf_counter()
    edit = cfg["edit"]
    targets = sd_targets.select_targets(
        {k: v.float().cpu() for k, v in w["dit"].items() if sd_targets.is_flux_text_entry(k)},
        "flux")
    res = edit_flux.FluxEditResources(
        targets=targets, t5_params=t5_params, t5_config=tcfg, t5_tokenizer=t5_tok,
        clip_params=clip, clip_config=ccfg, clip_tokenizer=clip_tok,
        max_sequence_length=cfg["max_sequence_length"], device=torch.device(device))
    edited = edit_flux.run_erase(res, edit["erase"], edit["guide"], edit["preserve"],
                                 lamb=edit["lamb"])
    path = os.path.join(workdir, "uce_edit.safetensors")
    save_safetensors(edited, path)
    pipe.load_uce_edits(path)
    phases["edit"] = time.perf_counter() - mark
    return {"pipe": pipe}


def generate(system, rows, traffic) -> object:
    """One eval-protocol call of ``generate-flux``: uint8 images [rows x
    samples, H, W, 3]."""
    return system["pipe"]([p for p, _ in rows], num_inference_steps=traffic["steps"],
                          guidance_scale=traffic["guidance"],
                          num_images_per_prompt=traffic["samples"],
                          seed=[s for _, s in rows], height=traffic["size"],
                          width=traffic["size"])


def control(system) -> None:
    """The correctness check's control: the port's DiT W8A8 path
    (``generate-flux --quantize int8``)."""
    system["pipe"].quantize_weights("int8")


def free(system) -> None:
    system.clear()


def reference(cfg, traffic, seed, jobs, device, workdir):
    return ref.flux_images(cfg, traffic, seed, jobs, device)


def work(cfg, traffic) -> list:
    return ref.flux_work(cfg, traffic)
