"""The port's group_norm_act kernel wrapper on CPU tensors (its plain
version) against uce_tpu's Pallas kernel in interpret mode, on the cases of
tests/test_pallas_group_norm.py. Tolerance atol 0.06, rtol 0.05, as there:
bf16 outputs, and the two sides round x*gamma+beta and the SiLU at
different places. Then the kernel's planner on every GroupNorm of SD 1.4's
UNet and VAE, and a plain version that sums in the plan's order against
the Pallas kernel."""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.ops.pallas import group_norm as pallas_gn
from uce_tpu_torch.models import layers, unet, vae
from uce_tpu_torch.ops import kernels
from uce_tpu_torch.ops.kernels import group_norm as port_gn

TOL = dict(atol=0.06, rtol=0.05)


def _bf16_pair(a):
    """numpy -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _compare(x, scale, bias, groups, eps, act):
    xj, xt = _bf16_pair(x)
    sj, st = _bf16_pair(scale)
    bj, bt = _bf16_pair(bias)
    want = np.asarray(pallas_gn.group_norm_act(xj, sj, bj, groups, eps, act,
                                               interpret=True), np.float32)
    kernels.reset_launches()
    got = port_gn.group_norm_act(xt, st, bt, groups, eps, act)
    assert not any(kernels.launches().values())  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 64), 8),
    ((3, 4, 4, 320), 32),
    ((1, 16, 16, 128), 32),
])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_matches_pallas_kernel(shape, groups, act):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape) * 2 + 0.5
    c = shape[-1]
    got, want = _compare(x, rng.standard_normal(c), rng.standard_normal(c),
                         groups, 1e-5, act)
    np.testing.assert_allclose(got, want, **TOL)


def test_zero_variance_takes_eps():
    x = np.full((1, 4, 4, 32), 3.0)
    got, want = _compare(x, np.ones(32), np.zeros(32), 8, 1e-2, "none")
    np.testing.assert_allclose(got, 0.0, atol=1e-2)
    np.testing.assert_allclose(got, want, **TOL)


def test_row_tiling_case():
    """24x24 maps: H*W not a multiple of the TPU kernel's row tile."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 24, 24, 64))
    got, want = _compare(x, rng.standard_normal(64), rng.standard_normal(64), 8,
                         1e-5, "none")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,groups,want", [
    ((4, 64, 64, 320), 32, True),     # UNet, 64x64 level
    ((4, 32, 32, 1920), 32, True),    # UNet up path, concatenated skips
    ((4, 8, 8, 2560), 32, True),
    ((1, 512, 512, 128), 32, True),   # VAE, last up block
    ((2, 8, 8, 65), 8, False),        # C % groups
    ((2, 8, 8, 36), 4, False),        # C % 8 (16-byte vectors)
])
def test_supported_shape(shape, groups, want):
    assert port_gn.supported_shape(shape, groups, torch.bfloat16) is want
    assert not port_gn.supported_shape(shape, groups, torch.float32)


def test_rejects_unknown_act():
    x = torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="act"):
        port_gn.group_norm_act(x, torch.ones(8), torch.zeros(8), 4, 1e-5, "gelu")


class _ShapeOnly:
    """Stands in for a random array: carries a shape and nothing else."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __mul__(self, other):
        return self

    def astype(self, dtype):
        return self


class _ShapeRng:
    def standard_normal(self, shape):
        return _ShapeOnly(shape)


@functools.lru_cache(maxsize=None)
def _gn_calls(model: str, batch: int) -> tuple:
    """((x shape NHWC, groups), calls) of the group_norm_act wrapper in one
    SD 1.4 UNet forward at 64x64 latents or one VAE decode to 512x512, run
    on bf16 meta tensors (shapes only)."""
    seen = collections.Counter()

    def spy(x, scale, bias, groups=32, eps=1e-5, act="none"):
        seen[(tuple(x.shape), groups)] += 1
        return torch.empty(x.shape, device="meta", dtype=x.dtype)

    cfg, init = ((unet.SD14_UNET_CONFIG, unet.init_state_dict) if model == "unet"
                 else (vae.SD_VAE_CONFIG, vae.init_state_dict))
    params = {k: torch.empty(v.shape, device="meta", dtype=torch.bfloat16)
              for k, v in init(cfg, _ShapeRng()).items()}
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.gn_kernel, "group_norm_act", spy)
        mp.setattr(layers.conv_kernel, "conv3x3", lambda x, w, bias=None: torch.empty(
            (*x.shape[:3], w.shape[0]), device="meta", dtype=x.dtype))
        if model == "unet":
            unet.apply(params, torch.empty(batch, 4, 64, 64, **meta), 981.0,
                       torch.empty(batch, 77, 768, **meta), cfg)
        else:
            vae.decode(params, torch.empty(batch, 4, 64, 64, **meta), cfg)
    return tuple(sorted(seen.items()))


def x_bytes(shape):
    return int(np.prod(shape))


@pytest.mark.parametrize("model,batch,calls", [
    ("unet", 2, 61), ("unet", 4, 61), ("unet", 8, 61), ("unet", 16, 61),
    ("vae", 1, 30), ("vae", 4, 30),
])
def test_plan_covers_sd_shapes(model, batch, calls):
    """Every GroupNorm the kernel path runs in SD 1.4's UNet and VAE gets a
    plan: a slab of whole groups and 8-channel vectors, at most 16 blocks a
    cluster and 227 KB of shared memory a block, and blocks that cover every
    row and channel exactly once. Every map is resident (one launch) but
    the largest: those of 64x64 rows or more with over 96 KB of x per SM,
    and those whose slab no cluster holds (the VAE's 256^2 and 512^2
    levels), stream."""
    seen = _gn_calls(model, batch)
    assert sum(n for _, n in seen) == calls
    for (shape, groups), _ in seen:
        b, h, w, c = shape
        p = port_gn.plan(shape, groups)
        assert p.slab % (c // groups) == 0 and p.slab % 8 == 0 and c % p.slab == 0
        assert 1 <= p.cluster <= 16 and p.smem <= 227 * 1024
        cover = np.zeros((h * w, c), np.int32)
        if p.schedule == "resident":
            assert p.rows % p.box_rows == 0 and p.box_rows % 8 == 0
            assert p.rows // p.box_rows <= 8 and p.box_rows <= 256
            assert p.box_c <= 256 and p.box_c % 8 == 0 and p.slab % p.box_c == 0
            assert p.blocks == b * (c // p.slab) * p.cluster
            for s in range(c // p.slab):
                for r in range(p.cluster):
                    assert r * p.rows < h * w   # no block without rows
                    cover[r * p.rows:(r + 1) * p.rows, s * p.slab:(s + 1) * p.slab] += 1
        else:
            assert p.blocks == b * -(-h * w // p.rows)
            for t in range(0, h * w, p.rows):
                cover[t:t + p.rows] += 1
        assert (cover == 1).all()
        large = h * w >= 4096 and 2 * x_bytes(shape) > 96 * 1024 * port_gn.SMS
        assert (p.schedule == "stream") == (large or h >= 256)


@pytest.mark.parametrize("shape,groups,smem_x_max", [
    ((1, 32, 32, 64), 8, port_gn.SMEM_X_MAX),   # a 16-block cluster
    ((2, 24, 24, 320), 32, port_gn.SMEM_X_MAX),  # ragged rows, 4 slabs
    ((2, 16, 16, 128), 32, 1024),                # forced to stream
])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_planned_order_matches_pallas_kernel(shape, groups, smem_x_max, act):
    """The plain version with the plan's summation order (per block, then
    the blocks in rank order, then each group's channels) against the
    Pallas kernel in interpret mode."""
    p = port_gn.plan(shape, groups, smem_x_max=smem_x_max)
    assert (p.schedule == "stream") == (smem_x_max < port_gn.SMEM_X_MAX)
    if p.schedule == "resident":
        assert p.cluster > 1
    rng = np.random.default_rng(11)
    c = shape[-1]
    xj, xt = _bf16_pair(rng.standard_normal(shape) * 2 + 0.5)
    sj, st = _bf16_pair(rng.standard_normal(c))
    bj, bt = _bf16_pair(rng.standard_normal(c))
    want = np.asarray(pallas_gn.group_norm_act(xj, sj, bj, groups, 1e-5, act,
                                               interpret=True), np.float32)
    got = port_gn.group_norm_act_planned_reference(xt, st, bt, groups, 1e-5, act, p)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    plain = port_gn.group_norm_act_reference(xt, st, bt, groups, 1e-5, act)
    assert (got.float() - plain.float()).abs().max() <= 0.0625


@pytest.mark.parametrize("c,groups,slab", [
    (320, 32, 80), (640, 32, 80), (960, 32, 120), (1280, 32, 80), (1920, 32, 120),
    (2560, 32, 80), (512, 32, 64), (256, 32, 64), (128, 32, 64), (32, 8, 32),
])
def test_slab_channels(c, groups, slab):
    assert port_gn.slab_channels(c, groups) == slab
