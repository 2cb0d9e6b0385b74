"""Denoising loop: one batched model call over both CFG branches, the
guidance combine, and the scheduler's table-driven step, per plan call."""

from __future__ import annotations

from typing import Callable

import torch

from uce_tpu_torch.diffusion.schedulers import Plan


def cfg_combine(eps_branches: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """Classifier-free guidance over [uncond; cond] stacking."""
    eps_u, eps_c = eps_branches.chunk(2, dim=0)
    return eps_u + guidance_scale * (eps_c - eps_u)


def denoise(
    model_fn: Callable[[torch.Tensor, float], torch.Tensor],
    plan: Plan,
    latents: torch.Tensor,
    *,
    guidance_fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Run every call of ``plan`` with two guidance branches.

    model_fn(latents_in [2B, C, H, W], t) -> eps for [uncond; cond] (the
    closure carries the text context and any added conditioning).
    ``latents`` are the raw unit gaussians (init_noise_sigma applied here);
    each call's UNet input is scaled by ``plan.scale_model_input``. The
    scheduler arithmetic and its history run in fp32 whatever the latents'
    dtype.
    """
    lat = latents * plan.init_noise_sigma
    hist = plan.init_carry(lat)
    for i in range(plan.num_calls):
        lat_in = plan.scale_model_input(torch.cat([lat, lat]), i)
        eps = guidance_fn(model_fn(lat_in, float(plan.timesteps[i])))
        eps = eps.to(lat.dtype)
        new_lat, hist = plan.step(eps.float(), i, lat.float(), hist)
        lat = new_lat.to(lat.dtype)
    return lat
