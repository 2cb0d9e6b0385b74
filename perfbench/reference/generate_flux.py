"""The reference's FLUX.1-schnell text-to-image generation, and the work of
one image.

Given the seed, the benchmark's tokenizer vocabularies and the jobs to
check, it works out again what the system derived, in stages so that it
fits one card after the system is gone: the T5 and CLIP encodes of the
edit's concepts and of the jobs' prompts (then the T5 is dropped); the UCE
erase of ``context_embedder`` (T5 stream) and
``time_text_embed.text_embedder.linear_1`` (pooled CLIP stream), each
solved in float64 from the reference's own embeddings of its stream (the
upstream ``uce_flux_edit.py``: a concept's T5 embedding is its last real
token's hidden state, its CLIP embedding the pooled output); the initial
latents from each job's seed; every Euler step of the DiT; the 16-channel
VAE decode with ``shift_factor``, to uint8 levels not rounded. Float32
with TF32 off; weights stored in bfloat16 are taken to float32 where they
are used.

FLUX.1's VAE has no ``post_quant_conv``. The decoder reused from
``reference/sd.py`` applies one, so it is handed an exact identity there
(a 1x1 conv with an identity weight and a zero bias, exact in float32);
the system under test gets no such weight.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core import vocab as clip_vocab, vocab_t5
from perfbench.reference import flux, uce
from perfbench.reference.generate import float32_only, initial_latents, to_levels, vae_scale
from perfbench.reference.sd import vae_decode, vae_decoder_shapes
from perfbench.reference.t5 import t5_encode, t5_ids, t5_shapes
from perfbench.reference.text import clip_encode, clip_shapes
from perfbench.reference.tokenize import clip_ids
from perfbench.reference.weights import draw, part_seed

PARTS = {"dit": 10, "t5": 11, "clip": 12, "vae": 13}
CHANNELS_PART = 14
T5_TARGET = "context_embedder.weight"
CLIP_TARGET = "time_text_embed.text_embedder.linear_1.weight"


def vae_shapes(cfg) -> dict[str, tuple]:
    """The decoder's tensors; ``post_quant_conv`` only where the VAE has one."""
    s = vae_decoder_shapes(cfg)
    if not cfg.get("use_post_quant_conv", True):
        s = {k: v for k, v in s.items() if not k.startswith("post_quant_conv.")}
    return s


def shapes(cfg, part: str) -> dict[str, tuple]:
    return {"dit": lambda: flux.dit_shapes(cfg["transformer"]),
            "t5": lambda: t5_shapes(cfg["text_encoder_2"]),
            "clip": lambda: clip_shapes(cfg["text_encoder"]),
            "vae": lambda: vae_shapes(cfg["vae"])}[part]()


def flux_weights(cfg, seed, device, parts=tuple(PARTS)) -> dict:
    """The drawn weights: the DiT and the VAE in the served dtype, the text
    encoders in float32 (as the system runs them); the DiT's input channels
    spread (``spread_input_channels``)."""
    served = getattr(torch, cfg["dtype"])
    dtypes = {"dit": served, "vae": served, "t5": torch.float32, "clip": torch.float32}
    w = {k: draw(shapes(cfg, k), part_seed(seed, PARTS[k]), device, dtypes[k])
         for k in parts}
    if "dit" in w:
        spread_input_channels(w["dit"], cfg["dit_channel_log_std"],
                              part_seed(seed, CHANNELS_PART))
    return w


def spread_input_channels(dit: dict, log_std: float, seed: int) -> None:
    """Scales the input channels of every 2-D DiT weight in place by
    exp(log_std z), z ~ N(0, 1) drawn from ``seed``, over their root mean
    square: a trained DiT's weights have input channels of very different
    size, which the port's per-output-channel int8 weights must span, while
    the flat draw's are all alike. The product is taken in float32 and
    rounded once to the weight's dtype."""
    some = next(iter(dit.values()))
    if some.device.type == "meta" or not log_std:
        return
    gen = torch.Generator(some.device).manual_seed(seed)
    for v in dit.values():
        if v.ndim == 2:
            s = torch.randn(v.shape[1], generator=gen, device=v.device).mul_(log_std).exp_()
            v.mul_(s / s.square().mean().sqrt())


def with_identity_post_quant_conv(vae: dict, cfg) -> dict:
    if cfg.get("use_post_quant_conv", True):
        return vae
    lc = cfg["latent_channels"]
    some = next(iter(vae.values()))
    eye = torch.eye(lc, device=some.device, dtype=torch.float32)[:, :, None, None]
    return {**vae, "post_quant_conv.weight": eye,
            "post_quant_conv.bias": torch.zeros(lc, device=some.device)}


def encode(cfg, t5, clip, prompts, device):
    """(T5 hidden [B, L, d], T5 masks, CLIP pooled [B, d'])."""
    t5_vocab, c_vocab = vocab_t5.t5_vocab(), clip_vocab.clip_vocab()
    rows = [t5_ids(t5_vocab, p, cfg["max_sequence_length"]) for p in prompts]
    hidden = t5_encode(t5, cfg["text_encoder_2"],
                       torch.as_tensor([r[0] for r in rows], device=device))
    ids = [clip_ids(c_vocab, p, cfg["text_encoder"]["max_position_embeddings"])[0]
           for p in prompts]
    pooled = clip_encode(clip, cfg["text_encoder"], torch.as_tensor(ids, device=device))[1]
    return hidden, [r[1] for r in rows], pooled


def erase(dit: dict, edit: dict, t5_last, pooled) -> dict:
    """The two edited text-entry weights, each from its own stream."""
    n_e, n_g = len(edit["erase"]), len(edit["guide"])
    out = {}
    for name, emb in ((T5_TARGET, t5_last), (CLIP_TARGET, pooled)):
        out.update(uce.erase({name: dit[name].float()}, emb[:n_e], emb[n_e:n_e + n_g],
                             emb[n_e + n_g:]))
    return out


@torch.no_grad()
def flux_images(cfg, traffic, seed, jobs, device, chunk: int = 2):
    tcfg, vcfg = cfg["transformer"], cfg["vae"]
    with float32_only():
        w = flux_weights(cfg, seed, device, ("t5", "clip"))
        edit = cfg["edit"]
        hidden, masks, concept_pooled = encode(cfg, w["t5"], w["clip"],
                                               edit["erase"] + edit["guide"] + edit["preserve"],
                                               device)
        at = torch.as_tensor([sum(m) - 2 for m in masks], device=device)
        concept_t5 = hidden[torch.arange(len(masks), device=device), at]
        prompt_t5, _, prompt_pooled = encode(cfg, w["t5"], w["clip"], [j[0] for j in jobs],
                                             device)
        del w, hidden
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        w = flux_weights(cfg, seed, device, ("dit", "vae"))
        p = dict(w["dit"])
        p.update(erase(p, edit, concept_t5, concept_pooled))
        vae = with_identity_post_quant_conv({k: v.float() for k, v in w["vae"].items()}, vcfg)
        size = traffic["size"] // vae_scale(cfg)
        out = []
        for start in range(0, len(jobs), chunk):
            part = slice(start, start + chunk)
            n = len(jobs[part])
            x = flux.pack(initial_latents(jobs[part], (vcfg["latent_channels"], size, size),
                                          device))

            def model(x, t):
                return flux.dit(p, tcfg, x, prompt_t5[part], prompt_pooled[part],
                                torch.full((n,), t, device=device), size, size)

            x = flux.flow_match_euler(cfg["scheduler"], traffic["steps"], model, x)
            z = flux.unpack(x, size, size) / vcfg["scaling_factor"] + vcfg["shift_factor"]
            out += [to_levels(vae_decode(vae, vcfg, z[i:i + 1])) for i in range(n)]
        return np.concatenate(out)


# ---------------------------------------------------------------------------
# the work of one image, on meta tensors (no data)
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def flux_work(cfg, traffic) -> list:
    """[(label, fn, times)]: every model call that one image of this traffic
    costs (no guidance branches; the system encodes each image's copy of
    its prompt, so one T5 and one CLIP encode an image)."""
    tcfg, vcfg = cfg["transformer"], cfg["vae"]
    s = traffic["size"] // vae_scale(cfg)
    length = cfg["max_sequence_length"]
    w = {k: draw(shapes(cfg, k), 0, "meta", torch.float32) for k in PARTS}
    vae = with_identity_post_quant_conv(w["vae"], vcfg)
    return [("dit", lambda: flux.dit(w["dit"], tcfg, _meta(1, (s // 2) ** 2, tcfg["in_channels"]),
                                     _meta(1, length, tcfg["joint_attention_dim"]),
                                     _meta(1, tcfg["pooled_projection_dim"]), _meta(1), s, s),
             traffic["steps"]),
            ("vae", lambda: vae_decode(vae, vcfg, _meta(1, vcfg["latent_channels"], s, s)), 1),
            ("t5", lambda: t5_encode(w["t5"], cfg["text_encoder_2"],
                                     _meta(1, length, dtype=torch.long)), 1),
            ("clip", lambda: clip_encode(w["clip"], cfg["text_encoder"],
                                         _meta(1, cfg["text_encoder"]["max_position_embeddings"],
                                               dtype=torch.long)), 1)]
