"""The port's conv3x3 kernel wrapper on CPU tensors (its plain version)
against uce_tpu's Pallas conv3x3 in interpret mode, on the cases of
tests/test_pallas_conv.py plus the ragged channel counts of SD's latent
convs (Cin=4, Cout=4, Cout=3); the split-K path's plain versions on the
same and narrow UNet-shaped cases; and the plan that picks the kernel,
its tiles and its K split for every 3x3 conv of SD 1.4. Tolerance
rtol/atol 0.05, as there: bf16 outputs; the port adds the bias in fp32
before its one rounding, the Pallas path adds it in bf16 after."""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.ops.pallas import conv3x3 as pallas_conv
from uce_tpu_torch.models import layers, unet, vae
from uce_tpu_torch.ops import kernels
from uce_tpu_torch.ops.kernels import conv3x3 as port_conv

TOL = dict(rtol=0.05, atol=0.05)


def _bf16_pair(a):
    """numpy -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _run(x, w_hwio, bias):
    xj, xt = _bf16_pair(x)
    wj, wt = _bf16_pair(w_hwio)
    bj, bt = _bf16_pair(bias) if bias is not None else (None, None)
    want = np.asarray(pallas_conv.conv3x3(xj, wj, bj, interpret=True), np.float32)
    # HWIO -> OIHW (diffusers) -> the port's packed [Cout, 3, 3, Cin]
    w_oihw = wt.permute(3, 2, 0, 1)
    kernels.reset_launches()
    got = port_conv.conv3x3(xt, port_conv.pack_weight(w_oihw), bt)
    assert not any(kernels.launches().values())  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), want


def test_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    got, want = _run(rng.standard_normal((2, 8, 8, 12)),
                     rng.standard_normal((3, 3, 12, 20)) * 0.1,
                     rng.standard_normal(20) * 0.1)
    np.testing.assert_allclose(got, want, **TOL)


def test_center_tap_only_writes_every_channel():
    rng = np.random.default_rng(11)
    w = np.zeros((3, 3, 4, 20), np.float32)
    w[1, 1] = rng.standard_normal((4, 20))
    got, want = _run(rng.standard_normal((1, 6, 6, 4)), w, None)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[..., 10:]).sum() > 0


@pytest.mark.parametrize("cin,cout", [
    (4, 32),    # UNet conv_in, VAE decoder.conv_in
    (32, 4),    # UNet conv_out
    (32, 3),    # VAE decoder.conv_out
    (24, 40),
])
def test_ragged_channels_match_pallas_kernel(cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    got, want = _run(rng.standard_normal((2, 7, 9, cin)),
                     rng.standard_normal((3, 3, cin, cout)) * 0.2,
                     rng.standard_normal(cout) * 0.1)
    np.testing.assert_allclose(got, want, **TOL)


def test_pack_weight_layout():
    w = torch.arange(2 * 3 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3, 3)
    packed = port_conv.pack_weight(w)
    assert packed.is_contiguous() and tuple(packed.shape) == (2, 3, 3, 3)
    assert torch.equal(packed[1, 2, 0, :], w[1, :, 2, 0])


def test_rejects_mismatched_weights():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        port_conv.conv3x3(x, torch.zeros(4, 3, 3, 6, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# The wgmma kernel's split-K path in its plain versions, and the plan rules
# ---------------------------------------------------------------------------

SMS = 132  # an H100 SXM's SMs


@pytest.mark.parametrize("shape,cout,splits", [
    ((2, 8, 8, 12), 20, 2),     # the cases above, K split across taps
    ((1, 6, 6, 4), 20, 3),
    ((2, 7, 9, 32), 4, 4),
    ((2, 7, 9, 24), 40, 9),     # one tap per split
    ((2, 8, 8, 128), 64, 4),    # narrow UNet-shaped: Cin % 64 == 0
    ((1, 8, 8, 192), 96, 5),    # splits end inside a tap's channels
    ((2, 4, 4, 128), 3, 18),    # one 64-channel step per split
])
def test_split_partials_match_pallas_kernel(shape, cout, splits):
    """Per-split fp32 partial sums, then the fixed-order sum with the bias
    and one rounding, against uce_tpu's Pallas conv3x3 (interpret mode) at
    the file's tolerance; and against the unsplit plain version, which
    differs only by fp32 summation order before the one bf16 rounding."""
    rng = np.random.default_rng(sum(shape) * 10 + cout + splits)
    x = rng.standard_normal(shape)
    w_hwio = rng.standard_normal((3, 3, shape[3], cout)) / np.sqrt(9 * shape[3])
    bias = rng.standard_normal(cout) * 0.1
    _, want = _run(x, w_hwio, bias)
    xt = _bf16_pair(x)[1]
    wt = port_conv.pack_weight(_bf16_pair(w_hwio)[1].permute(3, 2, 0, 1))
    bt = _bf16_pair(bias)[1]
    parts = port_conv.conv3x3_partials_reference(xt, wt, splits)
    steps = 9 * -(-shape[3] // 64)
    per, n = port_conv.k_split(steps, splits)
    assert parts.dtype == torch.float32 and tuple(parts.shape) == (n, *shape[:3], cout)
    assert n <= splits and (n - 1) * per < steps <= n * per
    got = port_conv.split_reduce_reference(parts, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    whole = port_conv.conv3x3_reference(xt, wt, bt).float()
    assert float((got.float() - whole).norm() / whole.norm()) < 4e-3


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
def _conv_calls(model: str, batch: int) -> tuple:
    """((x shape NHWC, Cout), calls) of the conv3x3 wrapper in one SD 1.4
    UNet forward at 64x64 latents or one VAE decode to 512x512, run on meta
    bf16 tensors (shapes only)."""
    seen = collections.Counter()

    def spy(x, w, bias=None):
        seen[(tuple(x.shape), w.shape[0])] += 1
        return torch.empty((*x.shape[:3], w.shape[0]), device="meta", dtype=x.dtype)

    cfg, init = ((unet.SD14_UNET_CONFIG, unet.init_state_dict) if model == "unet"
                 else (vae.SD_VAE_CONFIG, vae.init_state_dict))
    params = {k: torch.empty(v.shape, device="meta", dtype=torch.bfloat16)
              for k, v in init(cfg, _ShapeRng()).items()}
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.conv_kernel, "conv3x3", spy)
        mp.setattr(layers.gn_kernel, "group_norm_act", lambda x, *a, **kw: torch.empty(
            x.shape, device="meta", dtype=x.dtype))
        if model == "unet":
            unet.apply(params, torch.empty(batch, 4, 64, 64, **meta), 981.0,
                       torch.empty(batch, 77, 768, **meta), cfg)
        else:
            vae.decode(params, torch.empty(batch, 4, 64, 64, **meta), cfg)
    return tuple(sorted(seen.items()))


@pytest.mark.parametrize("model,batch,convs,split_levels", [
    ("unet", 4, 49, (8, 16)),   # 2 x 8 and 8 x 8 output tiles at 8x8 / 16x16
    ("unet", 8, 49, (8,)),
    ("vae", 1, 33, ()),
])
def test_plan_rules_on_sd_shapes(model, batch, convs, split_levels):
    """Every 3x3 conv of SD 1.4's UNet (batch 4 and 8) and VAE decoder: the
    latent-input conv (Cin = 4) takes the mma.sync kernel and every other
    one the wgmma kernel; a wgmma tile is 128 pixels; each split is
    non-empty and the splits cover the K steps exactly once; splitting
    never overfills the card; the named levels split."""
    calls = _conv_calls(model, batch)
    assert sum(n for _, n in calls) == convs
    variants = collections.Counter()
    for (shape, cout), n in calls:
        p = port_conv.plan(*shape, cout, SMS)
        variants[p.variant] += n
        assert (p.variant == "mma") == (shape[3] == 4)
        assert p.n_tiles == -(-cout // p.bn)
        if p.variant == "mma":
            assert p.splits == 1
            continue
        assert p.nb * p.th * p.tw == port_conv.TILE_PIXELS
        assert p.ksteps == 9 * shape[3] // 64
        ranges = [range(z * p.per, min(p.ksteps, (z + 1) * p.per))
                  for z in range(p.splits)]
        assert all(len(r) > 0 for r in ranges)
        assert [k for r in ranges for k in r] == list(range(p.ksteps))
        tiles = p.m_tiles * p.n_tiles
        assert p.splits == 1 or tiles * p.splits <= SMS
        assert (p.splits > 1) == (shape[1] in split_levels)
    assert variants == {"mma": 1, "wgmma": convs - 1}


def test_plan_picks_the_tile_that_pads_cout_least():
    tiles = {cout: port_conv.plan(4, 64, 64, 320, cout, SMS).bn
             for cout in (3, 4, 128, 256, 320, 512, 640, 1280)}
    assert tiles == {3: 64, 4: 64, 128: 128, 256: 128, 320: 160, 512: 128,
                     640: 160, 1280: 160}
