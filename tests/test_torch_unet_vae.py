"""The port's UNet and VAE decoder against uce_tpu, with weights carried
over from uce_tpu's params by uce_tpu_torch.models.convert. Tolerances are
those of tests/test_unet_cross_impl.py (fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_goldens import GOLDEN_PATH
from tests.torch_threads import one_torch_thread  # noqa: F401
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


def _jit_unet(jcfg):
    """uce_tpu's UNet forward, jitted with the config closed over."""
    return jax.jit(lambda p, x, t, c: junet.apply(p, x, t, c, jcfg))


def _jit_decode(jcfg):
    return jax.jit(lambda p, z: jvae.decode(p, z, jcfg))


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
    want = np.asarray(_jit_unet(jcfg)(jparams, jnp.asarray(x), jnp.asarray(t),
                                      jnp.asarray(ctx)))
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
    want = np.asarray(_jit_unet(jcfg)(junet.nest_state_dict(ref_flat), jnp.asarray(x),
                                      jnp.asarray([500.0]), jnp.asarray(ctx)))
    got = tunet.apply(tunet.load_params(flat, device="cpu"), _nchw(x), 500.0,
                      torch.from_numpy(ctx), tcfg)
    np.testing.assert_allclose(_nhwc(got), want, rtol=3e-4, atol=3e-4)


def test_overlay_edits_matches_uce_tpu():
    cfg_kw = dict(TINY, cross_attention_dim=24)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    flat = junet.init_state_dict(jcfg, np.random.default_rng(2), scale=0.1)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"
    edit = np.random.default_rng(3).standard_normal(flat[key].shape).astype(np.float32)
    jparams = junet.overlay_edits(junet.nest_state_dict(flat), {key: edit})
    tparams = tunet.overlay_edits(tunet.load_params(flat, device="cpu"),
                                  {key: torch.from_numpy(edit), "missing.weight":
                                   torch.zeros(1)})
    assert torch.equal(tparams[key], torch.from_numpy(edit))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 5, 24)).astype(np.float32)
    want = np.asarray(_jit_unet(jcfg)(jparams, jnp.asarray(x), jnp.asarray([10.0]),
                                      jnp.asarray(ctx)))
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
    want = np.asarray(_jit_decode(jcfg)(jparams, jnp.asarray(lat)))
    got = tvae.decode(tunet.load_params(flat, device="cpu"), _nchw(lat), tcfg)
    np.testing.assert_allclose(_nhwc(got), want, rtol=2e-4, atol=2e-4)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def kernel_path(monkeypatch):
    """Count calls of the kernels' plain versions (what a CPU tensor takes
    on the kernel route), and record the shape of every activation whose
    NHWC view for a kernel was a copy rather than a view of the model's own
    (channels_last) memory."""
    from uce_tpu_torch.models import layers
    from uce_tpu_torch.ops.kernels import conv3x3 as ck, group_norm as gk

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
    """SD 1.4's topology at 1/40 width in bf16, nothing set: every 3x3
    stride-1 conv and every GroupNorm takes the kernels' wrappers (49 and 61
    per forward, SD 1.4's counts), each on a free NHWC view of the
    activation."""
    cfg_kw = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                  cross_attention_dim=24, attention_head_dim=2, norm_num_groups=4)
    jcfg, tcfg = junet.UNetConfig(**cfg_kw), tunet.UNetConfig(**cfg_kw)
    flat = tunet.init_state_dict(tcfg, np.random.default_rng(11), scale=0.1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 24)).astype(np.float32)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in flat.items()}
    want = np.asarray(_jit_unet(jcfg)(junet.nest_state_dict(jp),
                                      jnp.asarray(x, jnp.bfloat16), jnp.asarray([500.0]),
                                      jnp.asarray(ctx, jnp.bfloat16)), np.float32)
    got = tunet.apply(tunet.load_params(flat, dtype=torch.bfloat16, device="cpu"),
                      _nchw(x).bfloat16(), 500.0,
                      torch.from_numpy(ctx).bfloat16(), tcfg)
    calls, copies = kernel_path
    assert calls == {"conv3x3": 49, "group_norm_act": 61}
    assert copies == []
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _rel_l2(_nhwc(got.float()), want) < BF16_REL_L2


def test_vae_kernel_path_bf16_matches_uce_tpu(kernel_path):
    """The SD VAE decoder's topology at 1/16 width in bf16, nothing set: 33
    conv3x3 and 30 group_norm_act calls (SD's counts: conv_norm_out with its
    SiLU and the mid-block attention's norm among them), each on a free NHWC
    view."""
    cfg_kw = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                  norm_num_groups=4)
    jcfg, tcfg = jvae.VAEConfig(**cfg_kw), tvae.VAEConfig(**cfg_kw)
    flat = tvae.init_state_dict(tcfg, np.random.default_rng(2), scale=0.1)
    lat = np.random.default_rng(4).standard_normal((1, 8, 8, 4)).astype(np.float32)
    jp = junet.nest_state_dict({k: jnp.asarray(v, jnp.bfloat16)
                                for k, v in flat.items()})
    want = np.asarray(_jit_decode(jcfg)(jp, jnp.asarray(lat, jnp.bfloat16)), np.float32)
    got = tvae.decode(tunet.load_params(flat, dtype=torch.bfloat16, device="cpu"),
                      _nchw(lat).bfloat16(), tcfg)
    calls, copies = kernel_path
    assert calls == {"conv3x3": 33, "group_norm_act": 30}
    assert copies == []
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert _rel_l2(_nhwc(got.float()), want) < BF16_REL_L2


SD_TOPOLOGY = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                   norm_num_groups=4)


def _run_model(model, dtype):
    """One forward of SD 1.4's UNet (``unet``; ``unet_linear``: with linear
    projections, as SD 2.1 and SDXL) or VAE decoder topology at a tiny width,
    on the CPU in ``dtype``."""
    rng = np.random.default_rng(5)
    if model == "vae":
        cfg = tvae.VAEConfig(**SD_TOPOLOGY)
        p = tunet.load_params(tvae.init_state_dict(cfg, rng, scale=0.1),
                              dtype=dtype, device="cpu")
        return tvae.decode(p, torch.randn(1, 4, 8, 8, dtype=dtype), cfg)
    cfg = tunet.UNetConfig(**SD_TOPOLOGY, cross_attention_dim=24, attention_head_dim=2,
                           use_linear_projection=model == "unet_linear")
    p = tunet.load_params(tunet.init_state_dict(cfg, rng, scale=0.1), dtype=dtype,
                          device="cpu")
    return tunet.apply(p, torch.randn(2, 4, 16, 16, dtype=dtype), 500.0,
                       torch.randn(2, 7, 24, dtype=dtype), cfg)


@pytest.mark.parametrize("model", ["unet", "unet_linear", "vae"])
def test_bf16_forward_keeps_channels_last(model):
    """Every op of a bf16 forward whose 4-D inputs are channels_last gives a
    channels_last result: the time-embedding and residual adds, the skip
    concatenation, the nearest upsample, the 1x1 convs and the transformer's
    permutes. Only the model's last op, the copy back to NCHW, leaves the
    layout."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def channels_last(t):
        return t.is_contiguous(memory_format=torch.channels_last)

    def spatial(t):
        return t.ndim == 4 and t.shape[1] > 1 and t.shape[2] * t.shape[3] > 1

    class Layouts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.checked, self.left = 0, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a for a in tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor) and a.ndim == 4]
            if ins and all(map(channels_last, ins)) and any(map(spatial, ins)):
                self.checked += 1
                stores = {a.untyped_storage().data_ptr() for a in ins}
                for o in tree_leaves(out):
                    # a view (the NHWC view of an activation) is no copy
                    if (isinstance(o, torch.Tensor) and spatial(o) and not channels_last(o)
                            and o.untyped_storage().data_ptr() not in stores):
                        self.left.append((str(func), tuple(o.shape)))
            return out

    with Layouts() as mode:
        out = _run_model(model, torch.bfloat16)
    assert mode.checked > 50
    assert mode.left == [("aten.clone.default", tuple(out.shape))]
    assert out.is_contiguous()


@pytest.mark.parametrize("model", ["unet", "vae"])
def test_fp32_forward_takes_no_kernel(kernel_path, model):
    """fp32 activations keep the library calls: no conv or GroupNorm takes
    a kernel's wrapper, and the forward stays NCHW."""
    out = _run_model(model, torch.float32)
    calls, copies = kernel_path
    assert calls == {"conv3x3": 0, "group_norm_act": 0} and copies == []
    assert out.dtype == torch.float32 and out.is_contiguous()
