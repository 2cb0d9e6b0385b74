"""FLUX's q/k RMSNorm + RoPE kernel (csrc/qk_norm_rope.cu) on a CUDA card,
against its plain version: at FLUX.1-schnell's 1024^2 block shapes at
batch 2 (a double-stream block's 256 T5 + 4096 image rows, a single-stream
block's joined 4352), FLUX.1-dev's 512 T5 rows and a model=2 rank's 12
heads, bit for bit (the kernel sums the squares in the order of PyTorch's
CUDA mean), and the same bits on a second call; and a DiT forward that
takes it once a block, equal to the plain version's. Marked ``card``: each test skips
without a card. This file imports no JAX; the tests directory's conftest
does, so on the card run it alone:

    python -m pytest --noconftest -m card tests/test_torch_qk_norm_rope_card.py
"""

import numpy as np
import pytest
import torch

from uce_tpu_torch.diffusion import pipeline_flux
from uce_tpu_torch.models import flux
from uce_tpu_torch.ops import kernels
from uce_tpu_torch.ops.kernels import qk_norm_rope as qk

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def block_inputs(device, b, h, s_txt, s_img, joined, seed=0):
    gen = torch.Generator(device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, device=device, generator=gen)
    side = int(round(s_img ** 0.5))
    lh, lw = (side, side) if side * side == s_img else (1, s_img)
    ids = np.concatenate([np.zeros((s_txt, 3)), pipeline_flux.make_img_ids(2 * lh, 2 * lw)])
    cos, sin = flux.rope_freqs(ids, flux.SCHNELL_CONFIG.axes_dims_rope, device=device)
    segments = []
    for s in ([s_txt + s_img] if joined else [s_txt, s_img]):
        src = lambda: (rnd(b, s, h * qk.HEAD_DIM) * 2 + 0.3).bfloat16()
        scale = lambda: (1 + 0.2 * rnd(qk.HEAD_DIM)).bfloat16()
        segments.append((src(), src(), scale(), scale()))
    return segments, cos, sin


@pytest.mark.parametrize("b,h,s_txt,s_img,joined", [
    (2, 24, 256, 4096, False), (2, 24, 256, 4096, True), (2, 24, 512, 4096, False),
    (1, 12, 256, 4096, False), (3, 1, 5, 16, False)])
def test_kernel_matches_the_plain_version(card, b, h, s_txt, s_img, joined):
    segments, cos, sin = block_inputs(card, b, h, s_txt, s_img, joined)
    got = qk.qk_norm_rope(segments, cos, sin)
    want = qk.qk_norm_rope_reference(segments, cos, sin)
    again = qk.qk_norm_rope(segments, cos, sin)
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        assert g.shape == (b, h, s_txt + s_img, qk.HEAD_DIM) and g.is_contiguous()
        assert torch.equal(g, a)
        assert torch.equal(g, w)


def test_flux_forward_takes_the_kernel_once_a_block(card):
    """A DiT of FLUX's head dim (2 heads, 1 + 2 blocks) in bf16: one launch
    a block, and the same output as the forward on the plain version."""
    cfg = flux.FluxConfig(in_channels=16, num_layers=1, num_single_layers=2,
                          num_attention_heads=2, joint_attention_dim=16,
                          pooled_projection_dim=24)
    params = flux.init_state_dict(cfg, seed=0, device=card)
    gen = torch.Generator(card).manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, device=card, generator=gen).bfloat16()
    args = (params, rnd(2, 64, 16), rnd(2, 8, 16), rnd(2, 24),
            torch.tensor([0.7, 0.3], device=card), pipeline_flux.make_img_ids(16, 16),
            np.zeros((8, 3)), cfg)
    before = kernels.launches()["qk_norm_rope"]
    got = flux.apply(*args)
    assert kernels.launches()["qk_norm_rope"] - before == 3
    with kernels.route(("qk_norm_rope",)):
        want = flux.apply(*args)
    assert kernels.launches()["qk_norm_rope"] - before == 3
    assert torch.equal(got, want)
