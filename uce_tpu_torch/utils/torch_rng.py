"""Initial latents with the reference's ``torch.Generator`` semantics, and
seeded random weights drawn on a device.

The reference seeds generation with ``torch.Generator().manual_seed(seed)``
and diffusers draws latents in NCHW on the CPU generator; the initial
latents are the only random input of the deterministic samplers, so this
is what fixed-seed image reproduction rests on. ``DeviceNormalRng`` stands
in for the numpy generator that the models' ``init_state_dict`` takes, so
full-width random weights are drawn on the card in fp16 (seconds for
SDXL's 3.5B parameters, where numpy's fp32 draws take minutes).
"""

from __future__ import annotations

import numpy as np
import torch


def randn(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator("cpu").manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def draw_prompt_latents(shape_hw_c, seed, n_prompts: int,
                        num_images_per_prompt: int) -> torch.Tensor:
    """NCHW float32 latents [n_prompts * num_images_per_prompt, c, h, w].

    int seed: one generator draws the whole batch in order (diffusers'
    single-generator batching). list seed: one generator per prompt, each
    drawing that prompt's ``num_images_per_prompt`` samples in order.
    """
    h, w, c = shape_hw_c
    if isinstance(seed, (int, np.integer)):
        return randn((n_prompts * num_images_per_prompt, c, h, w), int(seed))
    if len(seed) != n_prompts:
        raise ValueError("len(seed) must match len(prompt)")
    return torch.cat([randn((num_images_per_prompt, c, h, w), int(s))
                      for s in seed])


class _Drawn:
    """A drawn weight where init_state_dict expects a numpy array: scaling
    works in place, ``astype`` hands back the tensor in its drawn dtype."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __mul__(self, scale: float) -> "_Drawn":
        return _Drawn(self.t.mul_(scale))

    def astype(self, dtype) -> torch.Tensor:
        return self.t


class DeviceNormalRng:
    """``rng.standard_normal(shape)`` for init_state_dict on a seeded
    ``torch.Generator`` of ``device``, in ``dtype``."""

    def __init__(self, seed: int, device="cuda", dtype=torch.float16):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = torch.Generator(self.device).manual_seed(int(seed))

    def standard_normal(self, shape) -> _Drawn:
        return _Drawn(torch.randn(tuple(shape), generator=self.gen,
                                  device=self.device, dtype=self.dtype))
