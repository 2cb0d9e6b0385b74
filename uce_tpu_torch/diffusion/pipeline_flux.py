"""FLUX.1 text-to-image pipeline (flow matching), as
``uce_tpu/diffusion/pipeline_flux.py`` runs it: T5 + CLIP prompt encoding,
``num_inference_steps`` FlowMatchEuler steps of the joint transformer over
2x2-packed latent patches with (0, y, x) RoPE ids, then the 16-channel VAE
decode with ``shift_factor`` (schnell: 4 steps, guidance 0, 256 T5 tokens;
dev: an embedded guidance scale and dynamic sigma shifting).

Each call records the spans the SD pipeline records
(``utils/observability``): a ``pipe.call`` holding ``pipe.encode`` (the T5
and CLIP encodes), a ``pipe.model`` per DiT forward (with its kernel
launches, ``sampler.denoise``), a ``pipe.step`` per Euler step,
``pipe.decode`` (the unpack, the scale and shift, the VAE) and
``pipe.readback``.

``from_pretrained(quantize="w8"|"int8")`` quantizes the DiT as it loads,
tensor by tensor on the device (``quantize.FLUX_SKIP``), so the bf16 DiT
(23.7 GB at FLUX.1's widths, about 12 GB in int8) is never whole there.
``staged=True`` defers the DiT: encode the prompts, ``free_encoders()``, and
the DiT loads into the freed memory on the first ``generate_from_embeddings``
call, with the edits and quantization asked for before it (the reference's
three-phase load, ``uce_flux_edit.py:15-41``).

``apply_mesh`` runs the denoise and the decode on a mesh of processes, as
``pipeline.py``'s SD pipeline does, with the DiT laid out tensor-parallel
over the model axis (``mesh.flux_layout``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
from typing import Sequence

import numpy as np
import torch

from uce_tpu_torch.diffusion import schedulers
from uce_tpu_torch.diffusion.sampler import denoise
from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.edit.flux import (default_max_sequence_length, load_t5_encoder,
                                     load_t5_tokenizer)
from uce_tpu_torch.edit.sd import load_text_encoder, load_tokenizer
from uce_tpu_torch.models import clip_text, flux as flux_mod, quantize as quantize_mod
from uce_tpu_torch.models import t5 as t5_mod, unet as unet_mod, vae as vae_mod
from uce_tpu_torch.diffusion.pipeline import decoded_images, sample_batch
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, read_safetensors
from uce_tpu_torch.parallel import mesh as mesh_mod, workers
from uce_tpu_torch.utils import torch_rng
from uce_tpu_torch.utils.observability import span

# The edit slots of the DiT (uce_flux_edit.py's two text-entry projections).
EDIT_SLOTS = ("context_embedder.weight", "time_text_embed.text_embedder.linear_1.weight")


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, (h/2)(w/2), 4C] 2x2 patch packing, CHANNEL-major
    inner order (c, py, px): diffusers' FluxPipeline._pack_latents (NCHW
    view, permute (0, 2, 4, 1, 3, 5)), which real x_embedder / proj_out
    weights are trained against. HiDream's patchify is pixel-major: do not
    share this code with it."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of pack_latents -> [B, C, h, w]; h, w are the unpacked
    latent dims."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, h // 2, w // 2, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def make_img_ids(h: int, w: int) -> np.ndarray:
    """[S, 3] (0, y, x) grid over the packed patches, row-major."""
    ids = np.zeros(((h // 2) * (w // 2), 3), np.float64)
    ids[:, 1] = np.repeat(np.arange(h // 2), w // 2)
    ids[:, 2] = np.tile(np.arange(w // 2), h // 2)
    return ids


def compute_shift_mu(seq_len: int, base_seq=256, max_seq=4096,
                     base_shift=0.5, max_shift=1.15) -> float:
    """FLUX-dev dynamic shifting: mu linear in the image sequence length."""
    m = (max_shift - base_shift) / (max_seq - base_seq)
    return seq_len * m + (base_shift - m * base_seq)


def load_transformer(model_dir: str, dtype=torch.bfloat16, quantize: str | None = None,
                     device="cuda"):
    """(params, config) of the snapshot's DiT, read tensor by tensor straight
    into ``dtype`` on ``device``; given ``quantize``, each eligible weight is
    quantized as soon as it lands there (uce_tpu casts to ``dtype`` and then
    quantizes the same values, host-side)."""
    config = flux_mod.FluxConfig.from_hf(
        load_json(os.path.join(model_dir, "transformer", "config.json")))
    transform = (quantize_mod.quantizer(quantize_mod.FLUX_SKIP, quantize)
                 if quantize else None)
    params = load_state_dict(model_dir, "transformer", dtype=dtype, device=device,
                             transform=transform)
    return params, config


def release_memory(device: torch.device, what: str, before: str | None) -> None:
    """Collect the dropped tensors and hand the card's cached memory back,
    printing the allocated bytes before and after (``what`` names the
    step); a no-op off the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        print(f"{what}: {before} -> {cuda_allocated(device)} allocated on the card",
              flush=True)


def cuda_allocated(device: torch.device) -> str | None:
    """The card's allocated bytes, for the staged loads' prints (None off
    the card)."""
    if device.type != "cuda":
        return None
    return f"{torch.cuda.memory_allocated(device) / 1e9:.2f} GB"


@dataclasses.dataclass
class FluxPipeline:
    transformer_params: dict | None
    transformer_config: flux_mod.FluxConfig
    t5_params: dict | None
    t5_config: t5_mod.T5Config
    t5_tokenizer: object
    clip_params: dict | None
    clip_config: clip_text.CLIPTextConfig
    clip_tokenizer: object
    vae_params: dict
    vae_config: vae_mod.VAEConfig
    scheduler_config: dict
    dtype: torch.dtype = torch.bfloat16
    max_sequence_length: int = 256
    device: torch.device = torch.device("cuda")
    # staged loading: where the deferred DiT comes from, its quantization
    # and the edits to overlay once it is loaded
    model_dir: str | None = None
    pending_quantize: str | None = None
    pending_edits: list = dataclasses.field(default_factory=list)
    # the mesh of apply_mesh (None: this process alone)
    mesh: mesh_mod.Mesh | None = None

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype=torch.bfloat16,
                        max_sequence_length: int | None = None, staged: bool = False,
                        quantize: str | None = None, device="cuda") -> "FluxPipeline":
        """Load a FLUX snapshot directory. The DiT is read tensor by tensor
        straight into ``dtype`` on ``device`` (never a whole fp32 copy on the
        host) and, given ``quantize`` ("w8" or "int8"), quantized tensor by
        tensor there; the T5 and CLIP encoders run in fp32, as in uce_tpu.
        ``staged=True`` loads everything but the DiT, which waits for the
        first generation call (after ``free_encoders()``)."""
        if quantize is not None:
            quantize_mod.check_mode(quantize)
        device = torch.device(device)
        if staged:
            tparams, tcfg = None, flux_mod.FluxConfig.from_hf(
                load_json(os.path.join(model_dir, "transformer", "config.json")))
        else:
            tparams, tcfg = load_transformer(model_dir, dtype, quantize, device)
        t5_params, t5_cfg = load_t5_encoder(model_dir, device=device)
        cparams, ccfg = load_text_encoder(model_dir, device=device)
        vcfg = vae_mod.VAEConfig.from_hf(
            load_json(os.path.join(model_dir, "vae", "config.json")))
        vparams = unet_mod.load_params(load_state_dict(model_dir, "vae"), dtype, device)
        sp = os.path.join(model_dir, "scheduler", "scheduler_config.json")
        scfg = (load_json(sp) if os.path.exists(sp)
                else {"_class_name": "FlowMatchEulerDiscreteScheduler"})
        if max_sequence_length is None:
            max_sequence_length = default_max_sequence_length(model_dir)
        return cls(transformer_params=tparams, transformer_config=tcfg,
                   t5_params=t5_params, t5_config=t5_cfg,
                   t5_tokenizer=load_t5_tokenizer(model_dir),
                   clip_params=cparams, clip_config=ccfg,
                   clip_tokenizer=load_tokenizer(model_dir),
                   vae_params=vparams, vae_config=vcfg, scheduler_config=scfg,
                   dtype=dtype, max_sequence_length=max_sequence_length,
                   device=device, model_dir=model_dir, pending_quantize=quantize)

    def free_encoders(self) -> None:
        """Drop the T5 and CLIP encoders' weights and hand their memory back
        to the card; after this only ``generate_from_embeddings`` works."""
        before = cuda_allocated(self.device)
        self.t5_params = self.clip_params = None
        release_memory(self.device, "free_encoders", before)

    def quantize_weights(self, mode: str = "w8") -> None:
        """Quantize the DiT in place (``quantize.FLUX_SKIP``: the UCE edit
        targets stay float, so edit overlays apply exactly in either order);
        a staged pipeline quantizes the DiT as it loads. The encoders and the
        VAE stay as they are."""
        if self.transformer_params is None:
            self.pending_quantize = quantize_mod.check_mode(mode)
            return
        with dit_whole(self, "flux"):
            self.transformer_params = quantize_mod.quantize_params(
                self.transformer_params, quantize_mod.FLUX_SKIP, mode)

    def apply_mesh(self, mesh: mesh_mod.Mesh | None) -> None:
        """Multi-device generation (uce_tpu's ``apply_mesh``): the image batch
        is split over the mesh's data axis and, with a model axis > 1, the
        DiT is laid out tensor-parallel (``mesh.flux_layout``: head-sharded
        joint attention, column/row-parallel MLPs). On a staged pipeline the
        DiT's layout waits for its load, after the edits and quantization
        asked for. ``None`` stops the mesh's processes and puts the DiT back
        whole on this device."""
        apply_dit_mesh(self, mesh, "flux")

    def _ensure_transformer(self) -> None:
        if self.transformer_params is not None:
            return
        if self.model_dir is None:
            raise RuntimeError("staged pipeline has no model_dir to load the DiT from")
        self.transformer_params, self.transformer_config = load_transformer(
            self.model_dir, self.dtype, self.pending_quantize, self.device)
        for path in self.pending_edits:
            self.load_uce_edits(path)
        self.pending_edits = []
        send_dit(self, "flux")

    def load_uce_edits(self, safetensors_path: str) -> None:
        """Overlay UCE-edited text-entry projections (uce_flux_edit.py's
        artifacts: context_embedder / text_embedder.linear_1); other keys are
        skipped, a shape mismatch raises. A staged pipeline applies them when
        the DiT loads."""
        if self.transformer_params is None:
            self.pending_edits.append(safetensors_path)
            return
        with dit_whole(self, "flux"):
            for key, v in read_safetensors(safetensors_path).items():
                if key not in EDIT_SLOTS:
                    print(f"load_uce_edits: skipped unknown key {key}")
                    continue
                old = self.transformer_params[key]
                if tuple(v.shape) != tuple(old.shape):
                    raise ValueError(f"edit for '{key}' has shape {tuple(v.shape)}, "
                                     f"model expects {tuple(old.shape)}")
                self.transformer_params[key] = v.float().to(device=old.device,
                                                            dtype=self.dtype)

    @torch.inference_mode()
    def encode_prompts(self, prompts: Sequence[str]):
        """(T5 last hidden state [B, max_sequence_length, d], CLIP pooled
        [B, d']) in the pipeline's dtype. The T5 runs with no attention mask
        (pad tokens attend), as diffusers' FluxPipeline._get_t5_prompt_embeds."""
        if self.t5_params is None or self.clip_params is None:
            raise RuntimeError("encoders were freed (free_encoders); encode prompts "
                               "before freeing, then use generate_from_embeddings")
        # both id tensors go to the device before any encoder runs: a copy
        # from pageable memory waits for the device's queue to drain
        ids, _ = emb.tokenize_batch(self.t5_tokenizer, list(prompts),
                                    self.max_sequence_length)
        cids, _ = emb.tokenize_batch(self.clip_tokenizer, list(prompts),
                                     self.clip_config.max_position_embeddings)
        ids, cids = (torch.as_tensor(x, device=self.device) for x in (ids, cids))
        t5_out = t5_mod.encode_tokens(self.t5_params, ids, None, self.t5_config)
        _, pooled, _ = clip_text.encode_tokens(self.clip_params, cids, self.clip_config)
        return t5_out.to(self.dtype), pooled.to(self.dtype)

    def __call__(self, prompt: str | Sequence[str], num_inference_steps: int = 4,
                 guidance_scale: float = 0.0, num_images_per_prompt: int = 1,
                 seed: int | Sequence[int] = 0, height: int = 1024,
                 width: int = 1024) -> np.ndarray:
        """uint8 images [N, H, W, 3]."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        n_prompts = len(prompts)
        prompts = [p for p in prompts for _ in range(num_images_per_prompt)]
        with span("pipe.call", self.device, batch=len(prompts), steps=num_inference_steps):
            with span("pipe.encode", self.device):
                t5_embeds, pooled = self.encode_prompts(prompts)
            return self.generate_from_embeddings(
                t5_embeds, pooled, n_prompts=n_prompts,
                num_images_per_prompt=num_images_per_prompt,
                num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                seed=seed, height=height, width=width)

    @torch.inference_mode()
    def generate_from_embeddings(self, t5_embeds, pooled, n_prompts: int | None = None,
                                 num_images_per_prompt: int = 1,
                                 num_inference_steps: int = 4,
                                 guidance_scale: float = 0.0,
                                 seed: int | Sequence[int] = 0, height: int = 1024,
                                 width: int = 1024) -> np.ndarray:
        """Generate from precomputed (t5_embeds [B, S, d], pooled [B, d']),
        whose rows are already expanded per sample and may lie on the host
        (the staged path: this loads the DiT on its first call)."""
        self._ensure_transformer()
        bsz = t5_embeds.shape[0]
        if n_prompts is None:
            n_prompts = bsz // num_images_per_prompt
        if n_prompts * num_images_per_prompt != bsz or pooled.shape[0] != bsz:
            raise ValueError(
                f"t5_embeds rows ({bsz}) / pooled rows ({pooled.shape[0]}) must equal "
                f"n_prompts ({n_prompts}) x num_images_per_prompt "
                f"({num_images_per_prompt}); embeds must be pre-expanded per sample")
        vae_scale = 2 ** (len(self.vae_config.block_out_channels) - 1)
        gran = 2 * vae_scale  # VAE downsampling x the 2x2 patch pack
        if height % gran or width % gran:
            raise ValueError(f"height/width must be multiples of {gran} (got "
                             f"{height}x{width}): VAE scale {vae_scale} x the 2x2 "
                             "latent patchify")
        lh, lw = height // vae_scale, width // vae_scale
        latents = torch_rng.draw_prompt_latents(
            (lh, lw, self.vae_config.latent_channels), seed, n_prompts,
            num_images_per_prompt)
        if torch.device(self.device).type == "cuda":
            # from pinned memory the copy does not wait for the encodes queued
            # ahead of it, so the device does not idle while the host catches up
            latents = latents.pin_memory().to(self.device, non_blocking=True)
        latents = latents.to(self.device, self.dtype)
        lat = pack_latents(latents)
        scfg = self.scheduler_config
        use_dyn = scfg.get("use_dynamic_shifting", False)
        mu = compute_shift_mu(lat.shape[1], scfg.get("base_image_seq_len", 256),
                              scfg.get("max_image_seq_len", 4096),
                              scfg.get("base_shift", 0.5),
                              scfg.get("max_shift", 1.15)) if use_dyn else None
        cfg = self.transformer_config
        spec = {"dit_config": cfg, "vae_config": self.vae_config, "latent_hw": (lh, lw),
                "plan": dict(num_steps=num_inference_steps, shift=scfg.get("shift", 1.0),
                             use_dynamic_shifting=use_dyn, mu=mu),
                "img_ids": make_img_ids(lh, lw),
                "txt_ids": np.zeros((t5_embeds.shape[1], 3))}
        tensors = {"latents": (lat, 1), "t5": (t5_embeds.to(self.device, self.dtype), 1),
                   "pooled": (pooled.to(self.device, self.dtype), 1)}
        if cfg.guidance_embeds:
            tensors["guidance"] = (torch.full((bsz,), float(guidance_scale),
                                              device=self.device), 1)
        return sample_batch(self.mesh, _denoise_decode, spec, tensors,
                            {"dit": self.transformer_params, "vae": self.vae_params})


def _denoise_decode(params: dict, spec: dict, batch: dict) -> np.ndarray | None:
    """The Euler steps of the DiT (``sampler.denoise``: one branch, the
    velocity stepped as the DiT gives it) and the VAE decode of one batch (on a
    mesh: of a data group's rows, on each of its ranks; model ranks other
    than 0 return None without decoding)."""
    cfg, vae_config = spec["dit_config"], spec["vae_config"]
    lat, t5_embeds, pooled = batch["latents"], batch["t5"], batch["pooled"]
    bsz, device = lat.shape[0], lat.device
    plan = schedulers.flow_match_euler_plan(**spec["plan"])

    def model(lat_in, t, cond_only):
        t = np.float32(t) / np.float32(1000.0)  # the transformer re-scales by 1000
        return flux_mod.apply(params["dit"], lat_in, t5_embeds, pooled,
                              torch.full((bsz,), float(t), device=device),
                              spec["img_ids"], spec["txt_ids"], cfg,
                              guidance=batch.get("guidance"))

    lat = denoise(plan, lat, model)
    if workers.tp_rank() != 0:
        return None
    with span("pipe.decode", device):
        lat = unpack_latents(lat, *spec["latent_hw"]).float()
        lat = lat / vae_config.scaling_factor + vae_config.shift_factor
        imgs = vae_mod.decode(params["vae"], lat.to(t5_embeds.dtype), vae_config)
    return decoded_images(imgs, batch["rows"])


def denoiser_forward(params: dict, spec: dict, batch: dict):
    """One DiT forward as a mesh's ranks run it (``workers.run``): ``batch``
    holds ``latents``, ``t5``, ``pooled``, ``timesteps`` (and ``guidance``);
    ``spec`` the ``dit_config``, ``img_ids`` and ``txt_ids``. Model rank 0
    of each data group returns its output on the host, the others None."""
    out = flux_mod.apply(params["dit"], batch["latents"], batch["t5"], batch["pooled"],
                         batch["timesteps"], spec["img_ids"], spec["txt_ids"],
                         spec["dit_config"], guidance=batch.get("guidance"))
    return out.cpu() if workers.tp_rank() == 0 else None


def apply_dit_mesh(pipe, mesh: mesh_mod.Mesh | None, family: str) -> None:
    """A DiT pipeline's ``apply_mesh``: gather the DiT and stop the previous
    mesh, then start ``mesh`` and send it the VAE and the DiT (a staged
    pipeline's when it loads)."""
    if mesh is not None:
        mesh_mod.require_data_axis(mesh)
        mesh_mod.check_rank0(mesh, pipe.device)
    if pipe.mesh is not None:
        if pipe.transformer_params is not None:
            pipe.transformer_params = workers.gather_params("dit", pipe.transformer_params)
        workers.stop()
        pipe.mesh = None
    if mesh is None:
        return
    workers.start(mesh)
    pipe.mesh = mesh
    workers.send_params("vae", pipe.vae_params.items())
    send_dit(pipe, family)


def send_dit(pipe, family: str) -> None:
    """Lay a loaded DiT out on the pipeline's mesh (no-op without one):
    rank 0 keeps its shard, each of its whole tensors freed once sent."""
    if pipe.mesh is None or pipe.transformer_params is None:
        return
    layout = mesh_mod.layout_fn(family, pipe.transformer_config, pipe.mesh.n_model)
    items, pipe.transformer_params = workers.drain(pipe.transformer_params), None
    pipe.transformer_params = workers.send_params("dit", items, layout)


@contextlib.contextmanager
def dit_whole(pipe, family: str):
    """The whole DiT on this process for the enclosed change, laid out on
    the mesh again after it."""
    if pipe.mesh is None or not workers.holds("dit"):
        yield
        return
    pipe.transformer_params = workers.gather_params("dit", pipe.transformer_params)
    yield
    send_dit(pipe, family)
