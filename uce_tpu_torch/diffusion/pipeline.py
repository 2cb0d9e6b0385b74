"""Text-to-image pipeline for SD v1.x / v2.x and SDXL (two text encoders):
tokenize -> CLIP encode -> guided scheduler loop over the UNet (CFG, or a
comparison baseline's guidance: ``diffusion/guidance.py``) -> VAE decode ->
uint8 images. Each call is a ``pipe.call`` span holding its ``pipe.encode``,
the sampler's ``pipe.model`` and ``pipe.step`` spans, ``pipe.decode`` and
``pipe.readback`` (``utils/observability``).

``apply_mesh`` runs the denoise and the decode on a mesh of processes
(``parallel/workers.py``), as uce_tpu's sharded generate call: the image
batch is split over the data axis and the UNet laid out tensor-parallel
over the model axis; the encoders, the latents' draw and the plan stay on
the calling process.
"""

from __future__ import annotations

import contextlib
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
from uce_tpu_torch.parallel import mesh as mesh_mod, workers
from uce_tpu_torch.utils import torch_rng
from uce_tpu_torch.utils.imaging import save_png
from uce_tpu_torch.utils.observability import span


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
    # the mesh of apply_mesh (None: this process alone)
    mesh: mesh_mod.Mesh | None = None

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
        with self._whole_params():
            self.unet_params = unet_mod.overlay_edits(
                self.unet_params, read_safetensors(safetensors_path), dtype=self.dtype)

    def quantize_weights(self, mode: str = "w8") -> None:
        """Quantize the UNet and VAE weights in place (``models/quantize.py``):
        ``"int8"`` = W8A8 (int8 products, and the int8-QK^T attention kernel
        for the UNet's long self-attentions), ``"w8"`` = weight-only int8.
        Edits overlaid before or after: an overlay replaces a quantized slot
        with the float edit. On a mesh the ranks take the new weights."""
        with self._whole_params():
            self.unet_params = quantize.quantize_params(self.unet_params,
                                                        quantize.UNET_SKIP, mode)
            self.vae_params = quantize.quantize_params(self.vae_params,
                                                       quantize.VAE_SKIP, mode)

    def apply_mesh(self, mesh: mesh_mod.Mesh | None) -> None:
        """Multi-device generation (uce_tpu's ``apply_mesh``): the image batch
        is split over the mesh's data axis and, with a model axis > 1, the
        UNet is laid out tensor-parallel (``mesh.unet_layout``: whole heads
        of the attention projections, column/row-parallel GEGLU FFN). The
        mesh's other ranks are processes that this call spawns; rank 0 is
        this one, on the pipeline's device. ``None`` stops them and puts the
        UNet back whole on this device."""
        if mesh is not None:
            mesh_mod.require_data_axis(mesh)
            mesh_mod.check_rank0(mesh, self.device)
        if self.mesh is not None:
            self.unet_params = workers.gather_params("unet", self.unet_params)
            workers.stop()
            self.mesh = None
        if mesh is None:
            return
        workers.start(mesh)
        self.mesh = mesh
        self._send_params()

    def _send_params(self) -> None:
        layout = mesh_mod.layout_fn("unet", self.unet_config, self.mesh.n_model)
        items, self.unet_params = workers.drain(self.unet_params), None
        self.unet_params = workers.send_params("unet", items, layout)
        workers.send_params("vae", self.vae_params.items())

    @contextlib.contextmanager
    def _whole_params(self):
        """The whole weights on this process for the enclosed change, sent to
        the mesh's ranks again after it."""
        if self.mesh is None:
            yield
            return
        self.unet_params = workers.gather_params("unet", self.unet_params)
        workers.drop_params("vae")
        yield
        self._send_params()

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
                 fast: sampler.FastConfig | None = None,
                 save_paths: Sequence[str] | None = None) -> np.ndarray | None:
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
        no-op config takes the exact path.
        save_paths: one path per image: each image is written there as a
        PNG and None returned (on a mesh each data group writes its own:
        ``generate``'s writer)."""
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
        with span("pipe.call", self.device, batch=bsz, steps=num_inference_steps):
            with span("pipe.encode", self.device):
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
            spec = {"unet_config": self.unet_config, "vae_config": self.vae_config,
                    # a per-call scheduler changes the type only; the model's
                    # scheduler hyperparameters (prediction_type, betas, ...) carry over
                    "plan": (scheduler, self.scheduler_config, num_inference_steps),
                    "mode": mode, "guidance_scale": guidance_scale,
                    "sld_config": sld_config, "fast": fast, "save_paths": save_paths}
            tensors = {"latents": (latents, 1), "context": (context, n_branches)}
            if added_cond is not None:
                tensors.update({f"added.{k}": (v, n_branches) for k, v in added_cond.items()})
            images = sample_batch(self.mesh, _denoise_decode, spec, tensors,
                             {"unet": self.unet_params, "vae": self.vae_params})
            return None if save_paths is not None else images


def sample_batch(mesh, fn, spec: dict, tensors: dict, params: dict) -> np.ndarray:
    """``fn(params, spec, batch)`` (a denoise and decode returning uint8
    images) on this process, or on ``mesh``: each tensor given as (tensor,
    n_branches[, batch axis, 0 by default]) is padded per branch to a
    multiple of the data axis (``mesh.pad_batch_branched``), each data group
    denoises and decodes its rows, and the images of model rank 0 of each
    group come back in order, the padding cut off. ``batch["rows"]``
    numbers the rows (-1 for padding)."""
    bsz = tensors["latents"][0].shape[0]
    device = tensors["latents"][0].device
    rows = torch.arange(bsz, device=device)
    if mesh is None:
        batch = {name: t for name, (t, *_) in tensors.items()}
        return fn(params, spec, {**batch, "rows": rows})
    n_data = mesh.n_data
    padded = {"rows": (torch.cat([rows, rows.new_full(((-bsz) % n_data,), -1)]), (0, 1))}
    for name, (t, n_branches, *axis) in tensors.items():
        axis = axis[0] if axis else 0
        padded[name] = (mesh_mod.pad_batch_branched(t, n_data, n_branches, axis),
                        (axis, n_branches))
    out = workers.data_leaders(workers.run(fn, spec, padded, params), mesh)
    if any(o is None for o in out):
        return None
    return np.concatenate(out)[:bsz]


def denoiser_forward(params: dict, spec: dict, batch: dict):
    """One UNet forward as a mesh's ranks run it (``workers.run``): ``batch``
    holds ``sample``, ``timesteps``, ``context`` and SDXL's ``added.*``;
    ``spec`` the ``unet_config``. Model rank 0 of each data group returns
    its output on the host, the others None."""
    added = {k[len("added."):]: v for k, v in batch.items() if k.startswith("added.")}
    out = unet_mod.apply(params["unet"], batch["sample"], batch["timesteps"],
                         batch["context"], spec["unet_config"], added_cond=added or None)
    return out.cpu() if workers.tp_rank() == 0 else None


def _denoise_decode(params: dict, spec: dict, batch: dict) -> np.ndarray | None:
    """The guided denoise and the VAE decode of one batch (on a mesh: of a
    data group's rows, on each of its ranks). Returns the uint8 images, or
    writes row r's image to ``spec["save_paths"][r]`` and returns None;
    other model ranks than 0 return None without decoding."""
    unet_params, unet_config = params["unet"], spec["unet_config"]
    vae_config = spec["vae_config"]
    latents, context = batch["latents"], batch["context"]
    added_cond = {k[len("added."):]: v for k, v in batch.items() if k.startswith("added.")}
    added_cond = added_cond or None
    scheduler, scheduler_config, steps = spec["plan"]
    plan = (schedulers.plan_from_hf_as(scheduler, scheduler_config, steps) if scheduler
            else schedulers.plan_from_hf(scheduler_config, steps))
    mode, guidance_scale, fast = spec["mode"], spec["guidance_scale"], spec["fast"]
    bsz, dtype = latents.shape[0], latents.dtype
    cache_level = fast.cache_level if fast is not None else 1

    def model(lat_in, t, cond_only, deep=None, want_deep=False):
        ctx, ac = context, added_cond
        if cond_only:  # the cond half of the context and of SDXL's added conditioning
            ctx = context[bsz:]
            ac = None if added_cond is None else {k: v[bsz:] for k, v in added_cond.items()}
        return unet_mod.apply(unet_params, lat_in, t, ctx, unet_config, added_cond=ac,
                              deep_feature=deep, return_deep=want_deep,
                              cache_level=cache_level)

    # each guidance rounds its eps to the latents' dtype, as uce_tpu steps on it
    if mode == "sld":
        sld_cfg = spec["sld_config"] or guidance.SLDConfig()

        def guide(e, i, m):
            eps, m = guidance.sld_combine(e, guidance_scale, i, m, sld_cfg)
            return eps.to(dtype), m
        final = sampler.denoise(plan, latents, model, num_branches=3, guidance=guide,
                                guidance_state=torch.zeros_like(latents, dtype=torch.float32))
    elif mode == "concept_algebra":
        final = sampler.denoise(
            plan, latents, model, num_branches=5,
            guidance=lambda e: guidance.concept_algebra_combine(e, guidance_scale).to(dtype))
    else:
        final = sampler.denoise(
            plan, latents, model, num_branches=2, fast=fast,
            guidance=lambda e: sampler.cfg_combine(e.float(), guidance_scale).to(dtype))
    if workers.tp_rank() != 0:
        return None
    with span("pipe.decode", final.device):
        scaled = (final.float() / vae_config.scaling_factor).to(latents.dtype)
        imgs = vae_mod.decode(params["vae"], scaled, vae_config)
    return decoded_images(imgs, batch["rows"], spec["save_paths"])


def decoded_images(imgs: torch.Tensor, rows: torch.Tensor,
                   save_paths=None) -> np.ndarray | None:
    """Decoded images in [-1, 1] -> uint8 [N, H, W, 3]; given
    ``save_paths``, each row's PNG is written instead (the padding's not)."""
    with span("pipe.readback", imgs.device):
        imgs = (imgs.float() / 2 + 0.5).clamp(0.0, 1.0)
        imgs = torch.round(imgs * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    if save_paths is None:
        return imgs
    for img, row in zip(imgs, rows.tolist()):
        if row >= 0:
            save_png(img, save_paths[row])
    return None
