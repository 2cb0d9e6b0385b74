"""Text-to-image pipeline for SD v1.x / v2.x and SDXL (two text encoders):
tokenize -> CLIP encode -> guided scheduler loop over the UNet (CFG, or a
comparison baseline's guidance: ``diffusion/guidance.py``) -> VAE decode ->
uint8 images."""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from uce_tpu_torch.diffusion import guidance, sampler, schedulers
from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.edit.sd import load_text_encoder, load_tokenizer
from uce_tpu_torch.models import clip_text, quantize, unet as unet_mod, vae as vae_mod
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, read_safetensors
from uce_tpu_torch.utils import torch_rng


@dataclasses.dataclass
class SDPipeline:
    unet_params: dict
    unet_config: unet_mod.UNetConfig
    text_params: dict
    text_config: clip_text.CLIPTextConfig
    tokenizer: object
    vae_params: dict
    vae_config: vae_mod.VAEConfig
    scheduler_config: dict
    dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cuda")
    # SDXL's second encoder (None for SD v1/v2)
    text_params_2: dict | None = None
    text_config_2: clip_text.CLIPTextConfig | None = None
    tokenizer_2: object | None = None

    @property
    def is_sdxl(self) -> bool:
        return self.text_params_2 is not None

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype=torch.bfloat16,
                        device="cuda") -> "SDPipeline":
        """Load a diffusers snapshot (with ``text_encoder_2`` where it has
        one: SDXL)."""
        device = torch.device(device)
        ucfg = unet_mod.UNetConfig.from_hf(
            load_json(os.path.join(model_dir, "unet", "config.json")))
        vcfg = vae_mod.VAEConfig.from_hf(
            load_json(os.path.join(model_dir, "vae", "config.json")))
        unet_params = unet_mod.load_params(load_state_dict(model_dir, "unet"),
                                           dtype, device)
        vae_params = unet_mod.load_params(load_state_dict(model_dir, "vae"),
                                          dtype, device)
        tparams, tcfg = load_text_encoder(model_dir, device=device)
        sched_path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
        scfg = (load_json(sched_path) if os.path.exists(sched_path)
                else {"_class_name": "PNDMScheduler"})
        pipe = cls(unet_params=unet_params, unet_config=ucfg, text_params=tparams,
                   text_config=tcfg, tokenizer=load_tokenizer(model_dir),
                   vae_params=vae_params, vae_config=vcfg, scheduler_config=scfg,
                   dtype=dtype, device=device)
        if os.path.isdir(os.path.join(model_dir, "text_encoder_2")):
            pipe.text_params_2, pipe.text_config_2 = load_text_encoder(
                model_dir, "text_encoder_2", device=device)
            pipe.tokenizer_2 = load_tokenizer(model_dir, "tokenizer_2")
        return pipe

    def load_uce_edits(self, safetensors_path: str) -> None:
        """Overlay UCE-edited weights (load_state_dict(strict=False)); an
        edit of a quantized weight replaces it in the pipeline's dtype."""
        self.unet_params = unet_mod.overlay_edits(
            self.unet_params, read_safetensors(safetensors_path), dtype=self.dtype)

    def quantize_weights(self, mode: str = "w8") -> None:
        """Quantize the UNet and VAE weights in place (``models/quantize.py``):
        ``"int8"`` = W8A8 (int8 products, and the int8-QK^T attention kernel
        for the UNet's long self-attentions), ``"w8"`` = weight-only int8.
        Edits overlaid before or after: an overlay replaces a quantized slot
        with the float edit."""
        self.unet_params = quantize.quantize_params(self.unet_params,
                                                    quantize.UNET_SKIP, mode)
        self.vae_params = quantize.quantize_params(self.vae_params,
                                                   quantize.VAE_SKIP, mode)

    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        if self.is_sdxl:
            return self.encode_prompts_sdxl(prompts)[0]
        ids, _ = emb.tokenize_batch(self.tokenizer, list(prompts),
                                    self.text_config.max_position_embeddings)
        last_hidden, _, _ = clip_text.encode_tokens(
            self.text_params, torch.as_tensor(ids, device=self.device),
            self.text_config)
        return last_hidden.to(self.dtype)

    def encode_prompts_sdxl(self, prompts: Sequence[str]):
        """diffusers' SDXL encode_prompt: both encoders' penultimate hidden
        states concatenated [B, T, d1 + d2], and encoder 2's projected
        pooled vector [B, P]."""
        parts, pooled = [], None
        for params, config, tokenizer in (
                (self.text_params, self.text_config, self.tokenizer),
                (self.text_params_2, self.text_config_2, self.tokenizer_2)):
            ids, _ = emb.tokenize_batch(tokenizer, list(prompts),
                                        config.max_position_embeddings)
            _, pooled, hiddens = clip_text.encode_tokens(
                params, torch.as_tensor(ids, device=self.device), config,
                output_hidden_states=True)
            parts.append(hiddens[-2])
        return torch.cat(parts, dim=-1).to(self.dtype), pooled.to(self.dtype)

    def _sdxl_added_cond(self, pooled_cond, pooled_uncond, height: int,
                         width: int, n_branches: int = 2) -> dict[str, torch.Tensor]:
        """text_embeds (the negative prompt's pooled vector for the uncond
        branch, first; the extra guidance branches reuse the cond one) and
        time_ids [h, w, 0, 0, h, w] (original size, crop top-left, target
        size) for ``n_branches`` branches."""
        text_embeds = torch.cat([pooled_uncond] + [pooled_cond] * (n_branches - 1))
        time_ids = torch.tensor([height, width, 0, 0, height, width],
                                dtype=torch.float32, device=self.device)
        return {"text_embeds": text_embeds,
                "time_ids": time_ids.expand(text_embeds.shape[0], 6)}

    def _fast_model_factory(self, context, added_cond, bsz: int,
                            fast: sampler.FastConfig):
        """``sampler.denoise_fast``'s model factory: the cond-only variants
        take the cond half of the context and of SDXL's added conditioning."""
        def factory(cond_only: bool, cached: bool, want_deep: bool):
            ctx, ac = context, added_cond
            if cond_only:
                ctx = context[bsz:]
                ac = None if added_cond is None else {
                    k: v[bsz:] for k, v in added_cond.items()}
            if cached:
                return lambda lat_in, t, deep: unet_mod.apply(
                    self.unet_params, lat_in, t, ctx, self.unet_config,
                    added_cond=ac, deep_feature=deep, cache_level=fast.cache_level)
            return lambda lat_in, t: unet_mod.apply(
                self.unet_params, lat_in, t, ctx, self.unet_config, added_cond=ac,
                return_deep=want_deep, cache_level=fast.cache_level)
        return factory

    @torch.inference_mode()
    def __call__(self, prompt: str | Sequence[str], num_inference_steps: int = 50,
                 guidance_scale: float = 7.5, num_images_per_prompt: int = 1,
                 seed: int | Sequence[int] = 0, height: int = 512, width: int = 512,
                 scheduler: str | None = None, mode: str = "cfg",
                 negative_prompt: str | Sequence[str] | None = None,
                 concepts_to_project: Sequence[str] | None = None,
                 safety_concept: str | None = None,
                 sld_config: guidance.SLDConfig | None = None,
                 debias_projection: np.ndarray | None = None,
                 fast: sampler.FastConfig | None = None) -> np.ndarray:
        """Returns uint8 images [N, H, W, 3], guided against
        ``negative_prompt`` (the empty prompt by default; a string for every
        prompt or one per prompt, repeated per image).

        mode: ``"cfg"`` (default), ``"concept_algebra"`` (3
        ``concepts_to_project``; context [uncond; cond; p0; p1; p2]),
        ``"sld"`` (``safety_concept`` and an ``sld_config`` preset; context
        [uncond; cond; safety]) or ``"debias_vl"`` (``debias_projection`` P
        applied to the cond embeddings, then CFG). Each extra branch is
        encoded once and repeated for every image.
        fast: an optional ``sampler.FastConfig`` (CFG window, DeepCache),
        opt-in beyond the reference protocol, for cfg and debias_vl only; a
        no-op config takes the exact path."""
        if fast is not None and fast.is_noop:
            fast = None
        if mode not in ("cfg", "concept_algebra", "sld", "debias_vl"):
            raise ValueError(f"unknown mode: {mode}")
        if fast is not None and mode not in ("cfg", "debias_vl"):
            raise ValueError("fast modes support only cfg/debias_vl guidance")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        n_prompts = len(prompts)
        prompts = [p for p in prompts for _ in range(num_images_per_prompt)]
        bsz = len(prompts)
        if not isinstance(seed, (int, np.integer)) and len(seed) != n_prompts:
            raise ValueError("len(seed) must match len(prompt)")
        if negative_prompt is None:
            negatives = [""] * bsz
        elif isinstance(negative_prompt, str):
            negatives = [negative_prompt] * bsz
        else:
            negatives = [n for n in negative_prompt
                         for _ in range(num_images_per_prompt)]
            if len(negatives) != bsz:
                raise ValueError("len(negative_prompt) must match len(prompt)")
        if self.is_sdxl:  # encode once: the pooled vectors feed added_cond
            cond, pooled_cond = self.encode_prompts_sdxl(prompts)
            uncond, pooled_uncond = self.encode_prompts_sdxl(negatives)
        else:
            cond, uncond = self.encode_prompts(prompts), self.encode_prompts(negatives)

        if mode == "concept_algebra":
            if concepts_to_project is None or len(concepts_to_project) != 3:
                raise ValueError("concept_algebra needs exactly 3 concepts_to_project")
            extra = [self.encode_prompts([c]).repeat(bsz, 1, 1)
                     for c in concepts_to_project]
        elif mode == "sld":
            safety = safety_concept or guidance.DEFAULT_SAFETY_CONCEPT
            extra = [self.encode_prompts([safety]).repeat(bsz, 1, 1)]
        else:
            extra = []
            if mode == "debias_vl":
                if debias_projection is None:
                    raise ValueError(
                        "mode='debias_vl' needs a debias_projection matrix "
                        "(guidance.debias_vl_calibration)")
                proj = torch.as_tensor(np.asarray(debias_projection, np.float32),
                                       device=self.device)
                cond = (cond.float() @ proj.T).to(self.dtype)
        context = torch.cat([uncond, cond, *extra])
        n_branches = 2 + len(extra)
        added_cond = None
        if self.is_sdxl:
            added_cond = self._sdxl_added_cond(pooled_cond, pooled_uncond, height,
                                               width, n_branches)

        vae_scale = 2 ** (len(self.vae_config.block_out_channels) - 1)
        if height % vae_scale or width % vae_scale:
            raise ValueError(f"height/width must be multiples of {vae_scale} "
                             f"(got {height}x{width})")
        latents = torch_rng.draw_prompt_latents(
            (height // vae_scale, width // vae_scale, self.unet_config.in_channels),
            seed, n_prompts, num_images_per_prompt).to(self.device, self.dtype)
        # a per-call scheduler changes the type only; the model's scheduler
        # hyperparameters (prediction_type, betas, ...) carry over
        plan = (schedulers.plan_from_hf_as(scheduler, self.scheduler_config,
                                           num_inference_steps)
                if scheduler else
                schedulers.plan_from_hf(self.scheduler_config, num_inference_steps))

        def model_fn(lat_in, t):
            return unet_mod.apply(self.unet_params, lat_in, t, context,
                                  self.unet_config, added_cond=added_cond)

        if fast is not None:
            final = sampler.denoise_fast(
                self._fast_model_factory(context, added_cond, bsz, fast), plan,
                latents, guidance_scale=guidance_scale, fast=fast)
        elif mode == "sld":
            sld_cfg = sld_config or guidance.SLDConfig()
            final = sampler.denoise(
                model_fn, plan, latents,
                guidance_fn=lambda e, i, m: guidance.sld_combine(
                    e, guidance_scale, i, m, sld_cfg),
                num_branches=3,
                guidance_state=torch.zeros_like(latents, dtype=torch.float32))
        elif mode == "concept_algebra":
            final = sampler.denoise(
                model_fn, plan, latents,
                guidance_fn=lambda e: guidance.concept_algebra_combine(
                    e, guidance_scale),
                num_branches=5)
        else:
            final = sampler.denoise(
                model_fn, plan, latents,
                guidance_fn=lambda e: sampler.cfg_combine(e.float(), guidance_scale))
        scaled = (final.float() / self.vae_config.scaling_factor).to(latents.dtype)
        imgs = vae_mod.decode(self.vae_params, scaled, self.vae_config)
        imgs = (imgs.float() / 2 + 0.5).clamp(0.0, 1.0)
        imgs = torch.round(imgs * 255.0).to(torch.uint8)
        return imgs.permute(0, 2, 3, 1).cpu().numpy()
