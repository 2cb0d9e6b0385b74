"""HiDream-I1 text-to-image pipeline (flow matching, four text encoders), as
``uce_tpu/diffusion/pipeline_hidream.py`` runs it.

Conditioning: CLIP-L and CLIP-G pooled (concatenated), a T5 sequence and
Llama-3.1 hidden states (``hidden_states[1:]`` at the DiT config's
``llama_layers``), all at ``max_sequence_length`` = 128
(``uce_hidream_edit.py:220``). Then FlowMatchEuler steps of the MoE DiT,
which predicts the negated flow (``v = -pred``), under CFG with the
unconditional rows first, the Euler update in fp32, and the 16-channel VAE
with its ``shift_factor``. Each DiT call is a ``pipe.model`` span (with its
kernel launches), each CFG combine and Euler step a ``pipe.step``
(``sampler.denoise``), the decode a ``pipe.decode`` and the read-back a
``pipe.readback`` (``utils/observability``).

The encoders run in fp32 and the DiT in bf16, as uce_tpu loads them: at
HiDream-I1-Full's widths about 52 GB of encoders and 34 GB of DiT, more
than one 80 GB card holds at once. ``from_pretrained(staged=True)`` defers
the DiT: encode every prompt, ``free_encoders()``, then the DiT loads into
the freed memory on the first ``generate_from_embeddings`` call (the
reference's three-phase load, ``uce_hidream_edit.py:16-28, 51-64, 97-108``).
``quantize="w8"|"int8"`` quantizes the DiT tensor by tensor as it loads
(``quantize.HIDREAM_SKIP``): in w8 it takes about 17 GB, and the whole
pipeline fits one 80 GB card unstaged.

``apply_mesh`` runs the denoise and the decode on a mesh of processes, as
the SD and FLUX pipelines do, with the DiT's attention and SwiGLUs laid out
tensor-parallel and its routed experts expert-parallel over the model axis
(``mesh.hidream_layout``). The encoders run on rank 0 alone; a staged
pipeline frees them before the DiT loads there and its shards go out, so
two ranks sharing a card never hold the encoders and the DiT at once.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Sequence

import numpy as np
import torch

from uce_tpu_torch.diffusion import schedulers
from uce_tpu_torch.diffusion.pipeline import decoded_images, sample_batch
from uce_tpu_torch.diffusion.pipeline_flux import (apply_dit_mesh, compute_shift_mu,
                                                   cuda_allocated, dit_whole, make_img_ids,
                                                   release_memory, send_dit)
from uce_tpu_torch.diffusion.sampler import denoise
from uce_tpu_torch.edit import embeddings as emb
from uce_tpu_torch.edit.flux import load_t5_encoder, load_t5_tokenizer
from uce_tpu_torch.edit.hidream import (load_llama_encoder, load_llama_tokenizer,
                                        resolve_llama_dir)
from uce_tpu_torch.edit.sd import load_text_encoder, load_tokenizer
from uce_tpu_torch.models import clip_text, hidream as hd_mod, llama as llama_mod
from uce_tpu_torch.models import quantize as quantize_mod
from uce_tpu_torch.models import t5 as t5_mod, unet as unet_mod, vae as vae_mod
from uce_tpu_torch.models.hf_loader import load_json, load_state_dict, read_safetensors
from uce_tpu_torch.parallel import mesh as mesh_mod, workers
from uce_tpu_torch.utils import torch_rng
from uce_tpu_torch.utils.observability import span

_EDIT_KEY = re.compile(r"caption_projection\.(\d+)\.linear\.weight$")


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, (h/2)(w/2), 4C] 2x2 patch packing, PIXEL-major
    inner order (py, px, c): HiDream's own patchify (einops 'B C (H p1)
    (W p2) -> B (H W) (p1 p2 C)'), which its x_embedder and final layer
    are trained against. Not FLUX's channel-major packing."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(packed: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of pack_latents -> [B, C, h, w]; h, w are the unpacked
    latent dims."""
    b, _, c4 = packed.shape
    c = c4 // 4
    x = packed.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, c, h, w)


def load_transformer(model_dir: str, dtype=torch.bfloat16, device="cuda",
                     quantize: str | None = None):
    """(params, config) of the snapshot's MoE DiT, read tensor by tensor
    straight into ``dtype`` on ``device``; given ``quantize``, each eligible
    weight is quantized as soon as it lands there (uce_tpu casts to
    ``dtype`` and then quantizes the same values, host-side)."""
    config = hd_mod.HiDreamConfig.from_hf(
        load_json(os.path.join(model_dir, "transformer", "config.json")))
    transform = None
    if quantize:
        fn = quantize_mod.quantizer(quantize_mod.HIDREAM_SKIP, quantize)
        transform = lambda key, t: fn(hd_mod.convert_key(key), t)  # noqa: E731
    sd = load_state_dict(model_dir, "transformer", dtype=dtype, device=device,
                         transform=transform)
    return hd_mod.convert_hf_state_dict(sd), config


@dataclasses.dataclass
class HiDreamPipeline:
    transformer_params: dict | None
    transformer_config: hd_mod.HiDreamConfig
    clip_params: dict | None
    clip_config: clip_text.CLIPTextConfig
    clip_tokenizer: object
    clip_params_2: dict | None
    clip_config_2: clip_text.CLIPTextConfig
    clip_tokenizer_2: object
    t5_params: dict | None
    t5_config: t5_mod.T5Config
    t5_tokenizer: object
    llama_params: dict | None
    llama_config: llama_mod.LlamaConfig
    llama_tokenizer: object
    vae_params: dict
    vae_config: vae_mod.VAEConfig
    scheduler_config: dict
    dtype: torch.dtype = torch.bfloat16
    max_sequence_length: int = 128
    device: torch.device = torch.device("cuda")
    # staged loading: where the deferred DiT comes from, its quantization
    # and the edits to overlay once it is loaded
    model_dir: str | None = None
    pending_quantize: str | None = None
    pending_edits: list = dataclasses.field(default_factory=list)
    # the mesh of apply_mesh (None: this process alone)
    mesh: mesh_mod.Mesh | None = None

    @classmethod
    def from_pretrained(cls, model_dir: str, llama_dir: str | None = None,
                        dtype=torch.bfloat16, max_sequence_length: int = 128,
                        staged: bool = False, quantize: str | None = None,
                        device="cuda") -> "HiDreamPipeline":
        """Load a HiDream snapshot (and a Llama-3.1 snapshot, by default its
        ``text_encoder_4``). ``staged=True`` loads everything but the DiT,
        which waits for the first generation call (after
        ``free_encoders()``); ``quantize`` ("w8" or "int8") quantizes the DiT
        as it loads."""
        if quantize is not None:
            quantize_mod.check_mode(quantize)
        device = torch.device(device)
        llama_dir = resolve_llama_dir(model_dir, llama_dir)
        if staged:
            tparams, tcfg = None, hd_mod.HiDreamConfig.from_hf(
                load_json(os.path.join(model_dir, "transformer", "config.json")))
        else:
            tparams, tcfg = load_transformer(model_dir, dtype, device, quantize)
        cparams, ccfg = load_text_encoder(model_dir, "text_encoder", device)
        cparams2, ccfg2 = load_text_encoder(model_dir, "text_encoder_2", device)
        t5params, t5cfg = load_t5_encoder(model_dir, device, "text_encoder_3")
        lparams, lcfg = load_llama_encoder(llama_dir, device)
        tok4 = os.path.join(model_dir, "tokenizer_4")
        vcfg = vae_mod.VAEConfig.from_hf(
            load_json(os.path.join(model_dir, "vae", "config.json")))
        vparams = unet_mod.load_params(load_state_dict(model_dir, "vae"), dtype, device)
        sp = os.path.join(model_dir, "scheduler", "scheduler_config.json")
        scfg = (load_json(sp) if os.path.exists(sp)
                else {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 3.0})
        return cls(
            transformer_params=tparams, transformer_config=tcfg,
            clip_params=cparams, clip_config=ccfg,
            clip_tokenizer=load_tokenizer(model_dir, "tokenizer"),
            clip_params_2=cparams2, clip_config_2=ccfg2,
            clip_tokenizer_2=load_tokenizer(model_dir, "tokenizer_2"),
            t5_params=t5params, t5_config=t5cfg,
            t5_tokenizer=load_t5_tokenizer(model_dir, "tokenizer_3"),
            llama_params=lparams, llama_config=lcfg,
            llama_tokenizer=load_llama_tokenizer(tok4 if os.path.isdir(tok4) else llama_dir),
            vae_params=vparams, vae_config=vcfg, scheduler_config=scfg, dtype=dtype,
            max_sequence_length=max_sequence_length, device=device, model_dir=model_dir,
            pending_quantize=quantize)

    def free_encoders(self) -> None:
        """Drop the four text encoders' weights (CLIP-L/G, T5, Llama) and hand
        their memory back to the card (``torch.cuda.empty_cache``); after
        this only ``generate_from_embeddings`` works."""
        before = cuda_allocated(self.device)
        self.clip_params = self.clip_params_2 = self.t5_params = self.llama_params = None
        release_memory(self.device, "free_encoders", before)

    def quantize_weights(self, mode: str = "w8") -> None:
        """Quantize the MoE DiT in place (``quantize.HIDREAM_SKIP``: the
        caption projections, the UCE edit targets, and the MoE router stay
        float); a staged pipeline quantizes the DiT as it loads."""
        if self.transformer_params is None:
            self.pending_quantize = quantize_mod.check_mode(mode)
            return
        with dit_whole(self, "hidream"):
            self.transformer_params = quantize_mod.quantize_params(
                self.transformer_params, quantize_mod.HIDREAM_SKIP, mode)

    def apply_mesh(self, mesh: mesh_mod.Mesh | None) -> None:
        """Multi-device generation (uce_tpu's ``apply_mesh``): the image batch
        is split over the mesh's data axis (per CFG branch) and, with a model
        axis > 1, the DiT is laid out tensor- and expert-parallel
        (``mesh.hidream_layout``). On a staged pipeline the DiT's layout
        waits for its load. ``None`` stops the mesh's processes and puts the
        DiT back whole on this device."""
        apply_dit_mesh(self, mesh, "hidream")

    def _ensure_transformer(self) -> None:
        if self.transformer_params is not None:
            return
        if self.model_dir is None:
            raise RuntimeError("staged pipeline has no model_dir to load the DiT from")
        self.transformer_params, self.transformer_config = load_transformer(
            self.model_dir, self.dtype, self.device, self.pending_quantize)
        for path in self.pending_edits:
            self.load_uce_edits(path)
        self.pending_edits = []
        send_dit(self, "hidream")

    def load_uce_edits(self, safetensors_path: str) -> None:
        """Overlay UCE-edited caption projections (uce_hidream_edit.py's
        artifacts: 'caption_projection.<i>.linear.weight'); index n_llama
        is the T5 projection, a larger index or another shape raises, other
        keys are skipped. A staged pipeline applies them when the DiT loads."""
        if self.transformer_params is None:
            self.pending_edits.append(safetensors_path)
            return
        n_llama = self.transformer_config.num_caption_projections - 1
        with dit_whole(self, "hidream"):
            for key, v in read_safetensors(safetensors_path).items():
                m = _EDIT_KEY.match(key)
                if m is None:
                    print(f"load_uce_edits: skipped unknown key {key}")
                    continue
                i = int(m.group(1))
                if i > n_llama:
                    # Llama and T5 projections share a shape here: an artifact
                    # of another config must not land on the T5 slot
                    raise ValueError(f"{key}: index {i} exceeds this model's {n_llama} "
                                     "llama + 1 t5 caption projections")
                old = self.transformer_params[key]
                if tuple(v.shape) != tuple(old.shape):
                    raise ValueError(f"{key}: shape {tuple(v.shape)} does not match the "
                                     f"model's caption projection {tuple(old.shape)}")
                self.transformer_params[key] = v.float().to(device=old.device,
                                                            dtype=self.dtype)

    @torch.inference_mode()
    def encode_prompts(self, prompts: Sequence[str]):
        """(t5 [B, S, D], llama [num_blocks, B, S, D] at llama_layers, pooled
        [B, 768 + 1280]) in the pipeline's dtype."""
        if self.clip_params is None or self.t5_params is None or self.llama_params is None:
            raise RuntimeError("encoders were freed (free_encoders); encode prompts "
                               "before freeing, then use generate_from_embeddings")
        prompts = list(prompts)
        as_dev = lambda a: torch.as_tensor(a, device=self.device)
        pooled = []
        for params, cfg, tok in ((self.clip_params, self.clip_config, self.clip_tokenizer),
                                 (self.clip_params_2, self.clip_config_2,
                                  self.clip_tokenizer_2)):
            ids, _ = emb.tokenize_batch(tok, prompts, cfg.max_position_embeddings)
            pooled.append(clip_text.encode_tokens(params, as_dev(ids), cfg)[1])
        pooled = torch.cat(pooled, dim=-1).to(self.dtype)
        ids_t, mask_t = emb.tokenize_batch(self.t5_tokenizer, prompts,
                                           self.max_sequence_length)
        t5_out = t5_mod.encode_tokens(self.t5_params, as_dev(ids_t), as_dev(mask_t),
                                      self.t5_config).to(self.dtype)
        ids_l, mask_l = emb.tokenize_batch(self.llama_tokenizer, prompts,
                                           self.max_sequence_length)
        hidden = llama_mod.encode_tokens(self.llama_params, as_dev(ids_l), as_dev(mask_l),
                                         self.llama_config)
        layers = torch.as_tensor(self.transformer_config.llama_layers, device=self.device)
        llama = hidden[1:][layers].to(self.dtype)  # HF hidden_states[1:]
        return t5_out, llama, pooled

    def __call__(self, prompt: str | Sequence[str], num_inference_steps: int = 50,
                 guidance_scale: float = 5.0, num_images_per_prompt: int = 1,
                 seed: int | Sequence[int] = 0, height: int = 1024, width: int = 1024,
                 negative_prompt: str | Sequence[str] | None = None,
                 fast=None) -> np.ndarray:
        """uint8 images [N, H, W, 3]."""
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        n_prompts = len(prompts)
        prompts = [p for p in prompts for _ in range(num_images_per_prompt)]
        do_cfg = guidance_scale > 1.0
        embeds = self.encode_prompts(prompts)
        if do_cfg:
            if negative_prompt is None:
                negatives = [""] * len(prompts)
            elif isinstance(negative_prompt, str):
                negatives = [negative_prompt] * len(prompts)
            else:
                negatives = [n for n in negative_prompt for _ in range(num_images_per_prompt)]
                if len(negatives) != len(prompts):
                    raise ValueError("len(negative_prompt) must match len(prompt)")
            embeds = cfg_embeddings(self.encode_prompts(negatives), embeds)
        return self.generate_from_embeddings(
            *embeds, do_cfg=do_cfg, n_prompts=n_prompts,
            num_images_per_prompt=num_images_per_prompt,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            seed=seed, height=height, width=width, fast=fast)

    @torch.inference_mode()
    def generate_from_embeddings(self, t5_e, llama_e, pooled_e, do_cfg: bool = False,
                                 n_prompts: int | None = None,
                                 num_images_per_prompt: int = 1,
                                 num_inference_steps: int = 50,
                                 guidance_scale: float = 5.0,
                                 seed: int | Sequence[int] = 0, height: int = 1024,
                                 width: int = 1024, fast=None) -> np.ndarray:
        """Generate from precomputed embeddings (under CFG the unconditional
        rows first, as ``cfg_embeddings`` joins them), which may lie on the
        host: the staged path (encode, ``free_encoders()``, then this loads
        the DiT on its first call).

        ``fast``: a ``sampler.FastConfig`` with a ``cfg_interval`` window;
        outside it only the conditional rows run. ``cache_interval`` must be
        1 (a DiT has no deep UNet levels to cache); without CFG or a window
        it is ignored."""
        if fast is not None:
            if fast.cache_interval != 1:
                raise ValueError("HiDream fast mode supports cfg_interval only "
                                 "(a DiT has no deep UNet levels to cache)")
            if fast.cfg_interval is None or not do_cfg:
                fast = None
        self._ensure_transformer()
        rows = t5_e.shape[0]
        bsz = rows // (2 if do_cfg else 1)
        if n_prompts is None:
            n_prompts = bsz // num_images_per_prompt
        if (n_prompts * num_images_per_prompt * (2 if do_cfg else 1) != rows
                or pooled_e.shape[0] != rows or llama_e.shape[1] != rows):
            raise ValueError(
                f"embedding rows (t5 {rows}, pooled {pooled_e.shape[0]}, llama "
                f"{llama_e.shape[1]}) must equal n_prompts ({n_prompts}) x "
                f"num_images_per_prompt ({num_images_per_prompt})"
                + (" x 2 (CFG: uncond rows first)" if do_cfg else "")
                + "; embeds must be pre-expanded per sample")
        vae_scale = 2 ** (len(self.vae_config.block_out_channels) - 1)
        gran = 2 * vae_scale  # VAE downsampling x the 2x2 patch pack
        if height % gran or width % gran:
            raise ValueError(f"height/width must be multiples of {gran} (got "
                             f"{height}x{width}): VAE scale {vae_scale} x the 2x2 "
                             "latent patchify")
        lh, lw = height // vae_scale, width // vae_scale
        latents = torch_rng.draw_prompt_latents(
            (lh, lw, self.vae_config.latent_channels), seed, n_prompts,
            num_images_per_prompt).to(self.device, self.dtype)
        lat = pack_latents(latents)
        scfg = self.scheduler_config
        use_dyn = scfg.get("use_dynamic_shifting", False)
        mu = compute_shift_mu(lat.shape[1], scfg.get("base_image_seq_len", 256),
                              scfg.get("max_image_seq_len", 4096),
                              scfg.get("base_shift", 0.5),
                              scfg.get("max_shift", 1.15)) if use_dyn else None
        spec = {"dit_config": self.transformer_config, "vae_config": self.vae_config,
                "latent_hw": (lh, lw), "img_ids": make_img_ids(lh, lw),
                "plan": dict(num_steps=num_inference_steps, shift=scfg.get("shift", 3.0),
                             use_dynamic_shifting=use_dyn, mu=mu),
                "do_cfg": do_cfg, "guidance_scale": guidance_scale, "fast": fast}
        n_br = 2 if do_cfg else 1
        as_dev = lambda e: e.to(self.device, self.dtype)  # noqa: E731
        tensors = {"latents": (lat, 1), "t5": (as_dev(t5_e), n_br),
                   "llama": (as_dev(llama_e), n_br, 1),  # [layers, rows, ...]
                   "pooled": (as_dev(pooled_e), n_br)}
        return sample_batch(self.mesh, _denoise_decode, spec, tensors,
                            {"dit": self.transformer_params, "vae": self.vae_params})


def _denoise_decode(params: dict, spec: dict, batch: dict) -> np.ndarray | None:
    """The CFG Euler steps of the MoE DiT (``sampler.denoise``; outside a
    ``fast`` window the cond rows alone) and the VAE decode of one batch (on
    a mesh: of a data group's rows, on each of its ranks; model ranks other
    than 0 return None without decoding)."""
    cfg, vae_config = spec["dit_config"], spec["vae_config"]
    do_cfg, guidance_scale = spec["do_cfg"], float(spec["guidance_scale"])
    lat, t5_e, llama_e, pooled_e = (batch[k] for k in ("latents", "t5", "llama", "pooled"))
    bsz, device = lat.shape[0], lat.device
    plan = schedulers.flow_match_euler_plan(**spec["plan"])

    def model(lat_in, t, cond_only):
        te, le, pe = t5_e, llama_e, pooled_e
        if cond_only:  # outside the CFG window: the cond rows alone
            te, le, pe = t5_e[bsz:], llama_e[:, bsz:], pooled_e[bsz:]
        t = torch.full((lat_in.shape[0],), t, device=device)
        return -hd_mod.apply(params["dit"], lat_in, te, le, pe, t, spec["img_ids"],
                             cfg)  # HiDream predicts the negated flow

    def guide(v):  # CFG in fp32, stepped without rounding to the latents' dtype
        unc, txt = v.chunk(2)
        return unc.float() + guidance_scale * (txt - unc).float()

    lat = denoise(plan, lat, model, num_branches=2 if do_cfg else 1, guidance=guide,
                  fast=spec["fast"])
    if workers.tp_rank() != 0:
        return None
    with span("pipe.decode", device):
        lat = unpack_latents(lat, *spec["latent_hw"]).float()
        lat = lat / vae_config.scaling_factor + vae_config.shift_factor
        imgs = vae_mod.decode(params["vae"], lat.to(t5_e.dtype), vae_config)
    return decoded_images(imgs, batch["rows"])


def denoiser_forward(params: dict, spec: dict, batch: dict):
    """One DiT forward as a mesh's ranks run it (``workers.run``): ``batch``
    holds ``latents``, ``t5``, ``llama``, ``pooled`` and ``timesteps``;
    ``spec`` the ``dit_config`` and ``img_ids``. Model rank 0 of each data
    group returns its output on the host, the others None."""
    out = hd_mod.apply(params["dit"], batch["latents"], batch["t5"], batch["llama"],
                       batch["pooled"], batch["timesteps"], spec["img_ids"],
                       spec["dit_config"])
    return out.cpu() if workers.tp_rank() == 0 else None


def cfg_embeddings(uncond, cond):
    """Join (t5, llama, pooled) embeddings for CFG, the unconditional rows
    first (llama's rows are its second dim)."""
    return (torch.cat([uncond[0], cond[0]]), torch.cat([uncond[1], cond[1]], dim=1),
            torch.cat([uncond[2], cond[2]]))
