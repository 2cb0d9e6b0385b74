"""Fixed-seed latent parity with torch (the reference's RNG semantics)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.utils import torch_rng


def test_randn_matches_torch_generator_nchw():
    # diffusers draws latents [B, C, H, W] with torch.Generator().manual_seed
    # (generate-images-sd.py:41); our NHWC pipeline must transpose the SAME
    # draw, bit-exactly.
    gen = torch.Generator("cpu").manual_seed(1234)
    ref = torch.randn((2, 4, 8, 8), generator=gen).numpy()
    ours = torch_rng.randn((2, 8, 8, 4), 1234)
    np.testing.assert_array_equal(ours, ref.transpose(0, 2, 3, 1))


def test_randn_non4d_direct_layout():
    gen = torch.Generator("cpu").manual_seed(7)
    ref = torch.randn((3, 5), generator=gen).numpy()
    np.testing.assert_array_equal(torch_rng.randn((3, 5), 7), ref)


def test_different_seeds_differ():
    a = torch_rng.randn((1, 4, 4, 4), 1)
    b = torch_rng.randn((1, 4, 4, 4), 2)
    assert (a != b).any()


def test_draw_prompt_latents_int_seed_is_one_sequential_draw():
    got = torch_rng.draw_prompt_latents((4, 4, 2), 11, 2, 3)
    np.testing.assert_array_equal(got, torch_rng.randn((6, 4, 4, 2), 11))


def test_draw_prompt_latents_list_seed_distinct_within_prompt():
    # the round-1 bug: each of a prompt's num_images_per_prompt samples
    # drew the SAME (1,...) block from the same seed -> duplicate images
    got = torch_rng.draw_prompt_latents((4, 4, 2), [5, 9], 2, 2)
    assert got.shape == (4, 4, 4, 2)
    assert (got[0] != got[1]).any()  # samples of prompt 0 differ
    assert (got[2] != got[3]).any()  # samples of prompt 1 differ
    # each prompt's block is that generator advancing sequentially
    np.testing.assert_array_equal(got[:2], torch_rng.randn((2, 4, 4, 2), 5))
    np.testing.assert_array_equal(got[2:], torch_rng.randn((2, 4, 4, 2), 9))


def test_draw_prompt_latents_seed_length_validated():
    with pytest.raises(ValueError, match="len\\(seed\\)"):
        torch_rng.draw_prompt_latents((4, 4, 2), [1, 2, 3], 2, 1)
