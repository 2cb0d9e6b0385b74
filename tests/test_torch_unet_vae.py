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


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def kernel_path(monkeypatch):
    """Both kernel variables set; count calls of the kernels' plain versions
    (what a CPU tensor takes on the kernel path), and record the shape of
    every activation whose NHWC view for a kernel was a copy rather than a
    view of the model's own (channels_last) memory."""
    from uce_tpu_torch.models import layers
    from uce_tpu_torch.ops.kernels import conv3x3 as ck, group_norm as gk

    monkeypatch.setenv("UCE_CONV_IMPL", "pallas")
    monkeypatch.setenv("UCE_GN_IMPL", "pallas")
    calls = {"conv3x3": 0, "group_norm_act": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ck, "conv3x3_reference", spy("conv3x3", ck.conv3x3_reference))
    monkeypatch.setattr(gk, "group_norm_act_reference",
                        spy("group_norm_act", gk.group_norm_act_reference))
    copies = []
    nhwc = layers._nhwc

    def nhwc_spy(x):
        y = nhwc(x)
        if y.data_ptr() != x.data_ptr():
            copies.append(tuple(x.shape))
        return y

    monkeypatch.setattr(layers, "_nhwc", nhwc_spy)
    return calls, copies


# bf16 forwards: both sides round every activation to bf16, at different
# places (the port adds the conv bias in fp32, uce_tpu's XLA path in bf16),
# which at these widths and depths compounds to about 1.8e-2 relative.
BF16_REL_L2 = 3e-2


def test_unet_kernel_path_bf16_matches_uce_tpu(kernel_path):
    """SD 1.4's topology at 1/40 width in bf16 with UCE_CONV_IMPL and
    UCE_GN_IMPL set: every 3x3 stride-1 conv and every group_norm_act takes
    the kernels' wrappers (49 and 61 per forward, SD 1.4's counts), each on
    a free NHWC view of the activation."""
    cfg_kw = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                  cross_attention_dim=24, attention_head_dim=2, norm_num_groups=4)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    flat = tunet.init_state_dict(tcfg, np.random.default_rng(11), scale=0.1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in flat.items()}
    want = np.asarray(junet.apply(junet.nest_state_dict(jp),
                                  jnp.asarray(x, jnp.bfloat16), jnp.asarray([500.0]),
                                  jnp.asarray(ctx, jnp.bfloat16), jcfg), np.float32)
    got = tunet.apply(tunet.load_params(flat, dtype=torch.bfloat16),
                      _nchw(x).bfloat16(), 500.0,
                      torch.from_numpy(ctx).bfloat16(), tcfg)
    calls, copies = kernel_path
    assert calls == {"conv3x3": 49, "group_norm_act": 61}
    assert copies == []
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _rel_l2(_nhwc(got.float()), want) < BF16_REL_L2


def test_vae_kernel_path_bf16_matches_uce_tpu(kernel_path):
    """The SD VAE decoder's topology at 1/16 width in bf16 with both kernel
    variables set (33 conv3x3 and 28 group_norm_act calls, SD's counts, each
    on a free NHWC view)."""
    cfg_kw = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                  norm_num_groups=4)
    jcfg, tcfg = jvae.VAEConfig(**cfg_kw), tvae.VAEConfig(**cfg_kw)
    flat = tvae.init_state_dict(tcfg, np.random.default_rng(2), scale=0.1)
    lat = np.random.default_rng(4).standard_normal((1, 8, 8, 4)).astype(np.float32)
    jp = junet.nest_state_dict({k: jnp.asarray(v, jnp.bfloat16)
                                for k, v in flat.items()})
    want = np.asarray(jvae.decode(jp, jnp.asarray(lat, jnp.bfloat16), jcfg),
                      np.float32)
    got = tvae.decode(tunet.load_params(flat, dtype=torch.bfloat16),
                      _nchw(lat).bfloat16(), tcfg)
    calls, copies = kernel_path
    assert calls == {"conv3x3": 33, "group_norm_act": 28}
    assert copies == []
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _rel_l2(_nhwc(got.float()), want) < BF16_REL_L2
