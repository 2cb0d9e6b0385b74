"""Initial latents with the reference's ``torch.Generator`` semantics.

The reference seeds generation with ``torch.Generator().manual_seed(seed)``
and diffusers draws latents in NCHW on the CPU generator; the initial
latents are the only random input of the deterministic samplers, so this
is what fixed-seed image reproduction rests on.
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
