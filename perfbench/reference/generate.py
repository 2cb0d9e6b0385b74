"""The reference's text-to-image generation, and the work of one image.

Given the weights the benchmark drew (``*_weights``), the benchmark's
tokenizer files and the jobs to check, each function works out again what
the system derived: the UCE erase of the configuration's concepts (float64
solve from the base weights and the reference's own concept embeddings),
the initial latents from each job's seed (``torch.Generator("cpu")``, one
draw of ``samples`` images per seed, as diffusers batches a prompt), every
guided model call of the sampler, and the VAE decode to uint8 levels (not
rounded: the reference's rounding would add its own noise). Everything
runs in float32 with TF32 off; weights stored in bfloat16 are taken to
float32 where they are used.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from perfbench.reference import sched, uce
from perfbench.reference.sd import unet, unet_shapes, vae_decode, vae_decoder_shapes
from perfbench.reference.text import clip_encode, clip_shapes
from perfbench.reference.tokenize import clip_ids
from perfbench.reference.weights import draw, part_seed

SAMPLERS = {"PNDMScheduler": "pndm", "EulerDiscreteScheduler": "euler"}


@contextlib.contextmanager
def float32_only():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def sd_weights(cfg, seed, device) -> dict:
    served = getattr(torch, cfg["dtype"])
    return {"unet": draw(unet_shapes(cfg["unet"]), part_seed(seed, 0), device, served),
            "vae": draw(vae_decoder_shapes(cfg["vae"]), part_seed(seed, 1), device, served),
            "text": draw(clip_shapes(cfg["text_encoder"]), part_seed(seed, 2), device,
                         torch.float32)}


def sampler_name(cfg, traffic) -> str:
    return traffic.get("scheduler") or SAMPLERS[cfg["scheduler"]["_class_name"]]


def vae_scale(cfg) -> int:
    """Image pixels per latent pixel: the decoder doubles at each level but one."""
    return 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)


def model_calls(cfg, traffic) -> int:
    """Denoiser calls per image (PLMS re-steps its first interval)."""
    return traffic["steps"] + (sampler_name(cfg, traffic) == "pndm")


def initial_latents(jobs, shape, device) -> torch.Tensor:
    """jobs: (prompt, seed, sample, samples) -> the sample's initial noise."""
    return torch.stack([torch.randn((samples, *shape),
                                    generator=torch.Generator("cpu").manual_seed(int(seed)))[j]
                        for _, seed, j, samples in jobs]).to(device)


def to_levels(images: torch.Tensor) -> np.ndarray:
    """[B, 3, H, W] in [-1, 1] -> float32 [B, H, W, 3] in uint8 levels,
    clamped to [0, 255] and not rounded: what uint8 images round."""
    x = (images / 2 + 0.5).clamp(0, 1) * 255
    return x.permute(0, 2, 3, 1).cpu().numpy().astype(np.float32)


def _last_tokens(hidden, masks):
    at = torch.as_tensor([sum(m) - 2 for m in masks], device=hidden.device)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), at]


def _split_concepts(emb, edit):
    n_e, n_g = len(edit["erase"]), len(edit["guide"])
    return emb[:n_e], emb[n_e:n_e + n_g], emb[n_e + n_g:]


@torch.no_grad()
def sd_images(cfg, traffic, weights, vocab, jobs, device, chunk: int = 4) -> np.ndarray:
    ucfg, tcfg = cfg["unet"], cfg["text_encoder"]
    with float32_only():
        p = {k: v.float() for k, v in weights["unet"].items()}
        vae = {k: v.float() for k, v in weights["vae"].items()}
        text = weights["text"]

        def encode(prompts):
            rows = [clip_ids(vocab, t, tcfg["max_position_embeddings"]) for t in prompts]
            ids = torch.as_tensor([r[0] for r in rows], device=device)
            return clip_encode(text, tcfg, ids)[0], [r[1] for r in rows]

        edit = cfg["edit"]
        hidden, masks = encode(edit["erase"] + edit["guide"] + edit["preserve"])
        targets = {k: w for k, w in p.items()
                   if "attn2" in k and k.endswith(("to_k.weight", "to_v.weight"))}
        p.update(uce.erase(targets, *_split_concepts(_last_tokens(hidden, masks), edit)))
        run = getattr(sched, sampler_name(cfg, traffic))
        size = traffic["size"] // vae_scale(cfg)
        out = []
        for at in range(0, len(jobs), chunk):
            part = jobs[at:at + chunk]
            n = len(part)
            ctx = torch.cat([encode([""] * n)[0], encode([j[0] for j in part])[0]])
            x = initial_latents(part, (ucfg["in_channels"], size, size), device)

            def model(x, t):
                eps = unet(p, ucfg, torch.cat([x, x]), torch.full((2 * n,), t, device=device),
                           ctx)
                eu, ec = eps.chunk(2)
                return eu + traffic["guidance"] * (ec - eu)

            x = run(cfg["scheduler"], traffic["steps"], model, x)
            out.append(to_levels(vae_decode(vae, cfg["vae"], x / cfg["vae"]["scaling_factor"])))
        return np.concatenate(out)


# ---------------------------------------------------------------------------
# the work of one image, on meta tensors (no data)
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def sd_work(cfg, traffic) -> list:
    """[(label, fn, times)]: every model call that one image of this traffic
    costs (batch 1: CFG's two branches count twice)."""
    ucfg, tcfg, vcfg = cfg["unet"], cfg["text_encoder"], cfg["vae"]
    s = traffic["size"] // vae_scale(cfg)
    u = draw(unet_shapes(ucfg), 0, "meta", torch.float32)
    v = draw(vae_decoder_shapes(vcfg), 0, "meta", torch.float32)
    t = draw(clip_shapes(tcfg), 0, "meta", torch.float32)
    cfg_branches = 2 if traffic.get("guidance", 0) > 1 else 1
    return [("unet", lambda: unet(u, ucfg, _meta(1, ucfg["in_channels"], s, s), _meta(1),
                                  _meta(1, tcfg["max_position_embeddings"],
                                        ucfg["cross_attention_dim"])),
             model_calls(cfg, traffic) * cfg_branches),
            ("vae", lambda: vae_decode(v, vcfg, _meta(1, vcfg["latent_channels"], s, s)), 1),
            ("clip", lambda: clip_encode(t, tcfg, _meta(1, tcfg["max_position_embeddings"],
                                                        dtype=torch.long)), cfg_branches)]

