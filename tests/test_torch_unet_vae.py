"""The port's UNet and VAE decoder against uce_tpu, with weights carried
over from uce_tpu's params by uce_tpu_torch.models.convert. Tolerances are
those of tests/test_unet_cross_impl.py (fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_goldens import GOLDEN_PATH
from uce_tpu.models import unet as junet, vae as jvae
from uce_tpu_torch.models import unet as tunet, vae as tvae
from uce_tpu_torch.models.convert import nested_to_state_dict

TINY = dict(block_out_channels=(8, 16),
            down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            layers_per_block=1, attention_head_dim=2, norm_num_groups=4)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def test_unet_matches_golden():
    """The tiny UNet of tests/test_goldens.py against goldens.npz."""
    cfg_kw = dict(TINY, cross_attention_dim=32)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    params = nested_to_state_dict(junet.init_params(jcfg, seed=7))
    rng = np.random.default_rng(12345)
    # the draws that come before the UNet inputs in _compute_goldens
    for shape in ((10, 64), (10, 64), (5, 64), (24, 64)):
        rng.standard_normal(shape)
    x = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    got = tunet.apply(params, _nchw(x), torch.tensor([500.0]),
                      torch.from_numpy(ctx), tcfg)
    want = np.load(GOLDEN_PATH)["unet_forward"]
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_linear", [False, True])
def test_unet_matches_uce_tpu(use_linear):
    cfg_kw = dict(TINY, cross_attention_dim=24, use_linear_projection=use_linear)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    jparams = junet.nest_state_dict(
        junet.init_state_dict(jcfg, np.random.default_rng(3), scale=0.1))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    t = np.array([123.0, 801.0], np.float32)
    want = np.asarray(junet.apply(jparams, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx), jcfg))
    got = tunet.apply(nested_to_state_dict(jparams), _nchw(x),
                      torch.from_numpy(t), torch.from_numpy(ctx), tcfg)
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4, atol=2e-4)


def test_unet_sd14_structure_matches_uce_tpu():
    """Four blocks, two layers per block: the SD 1.4 topology at 1/40 width,
    with the port's own init_state_dict (same draws as uce_tpu's)."""
    cfg_kw = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                  cross_attention_dim=24, attention_head_dim=2, norm_num_groups=4)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    flat = tunet.init_state_dict(tcfg, np.random.default_rng(11), scale=0.1)
    ref_flat = junet.init_state_dict(jcfg, np.random.default_rng(11), scale=0.1)
    assert flat.keys() == ref_flat.keys()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 32, 32, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 7, 24)).astype(np.float32)
    want = np.asarray(junet.apply(junet.nest_state_dict(ref_flat), jnp.asarray(x),
                                  jnp.asarray([500.0]), jnp.asarray(ctx), jcfg))
    got = tunet.apply(tunet.load_params(flat), _nchw(x), 500.0,
                      torch.from_numpy(ctx), tcfg)
    np.testing.assert_allclose(_nhwc(got), want, rtol=3e-4, atol=3e-4)


def test_overlay_edits_matches_uce_tpu():
    cfg_kw = dict(TINY, cross_attention_dim=24)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    flat = junet.init_state_dict(jcfg, np.random.default_rng(2), scale=0.1)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    edit = np.random.default_rng(3).standard_normal(flat[key].shape).astype(np.float32)
    jparams = junet.overlay_edits(junet.nest_state_dict(flat), {key: edit})
    tparams = tunet.overlay_edits(tunet.load_params(flat),
                                  {key: torch.from_numpy(edit), "missing.weight":
                                   torch.zeros(1)})
    assert torch.equal(tparams[key], torch.from_numpy(edit))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 24)).astype(np.float32)
    want = np.asarray(junet.apply(jparams, jnp.asarray(x), jnp.asarray([10.0]),
                                  jnp.asarray(ctx), jcfg))
    got = tunet.apply(tparams, _nchw(x), 10.0, torch.from_numpy(ctx), tcfg)
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        tunet.overlay_edits(tparams, {key: torch.zeros(3, 3)})


def test_vae_decode_matches_uce_tpu():
    jcfg = jvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                          norm_num_groups=4)
    tcfg = tvae.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                          norm_num_groups=4)
    flat = tvae.init_state_dict(tcfg, np.random.default_rng(2), scale=0.1)
    jparams = junet.nest_state_dict(jvae.init_state_dict(
        jcfg, np.random.default_rng(2), scale=0.1))
    lat = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jvae.decode(jparams, jnp.asarray(lat), jcfg))
    got = tvae.decode(tunet.load_params(flat), _nchw(lat), tcfg)
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4, atol=2e-4)
