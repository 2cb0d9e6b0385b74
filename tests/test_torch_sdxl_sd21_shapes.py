"""The kernels' shapes on SD 2.1 (768x768, latents 96x96) and SDXL base
(1024x1024, latents 128x128) at their published widths: every 3x3 conv,
group_norm_act and attention call of one UNet forward (batch 2 and 8) and
one VAE decode (batch 1), enumerated by running the models on meta tensors
(shapes only, no weights), with the kernel path's launches per call, the
plans conv3x3.plan and group_norm.plan give each shape, and the attention
routing of each call."""

import collections
import functools

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.models import layers, unet, vae
from uce_tpu_torch.ops import attention
from uce_tpu_torch.ops.kernels import conv3x3 as port_conv
from uce_tpu_torch.ops.kernels import group_norm as port_gn
from uce_tpu_torch.ops.kernels import sd_attention as port_sdk

SMS = 132  # an H100 SXM
META = dict(device="meta", dtype=torch.bfloat16)
# (UNet config, latent size, text context width, added-cond input widths)
MODELS = {"sd14": (unet.SD14_UNET_CONFIG, 64, 768, None),
          "sd21": (unet.SD21_UNET_CONFIG, 96, 1024, None),
          "sdxl": (unet.SDXL_UNET_CONFIG, 128, 2048, (1280, 6))}


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
def _calls(model: str, part: str, batch: int):
    """Counters of the conv3x3 ((x NHWC, Cout)), group_norm_act ((x NHWC,
    groups)) and attention ((q shape, k shape)) calls of one forward (part
    "unet") or decode (part "vae") of ``model`` on the kernel path."""
    convs, norms, attns = (collections.Counter() for _ in range(3))

    def conv_spy(x, w, bias=None):
        convs[(tuple(x.shape), w.shape[0])] += 1
        return torch.empty((*x.shape[:3], w.shape[0]), device="meta", dtype=x.dtype)

    def gn_spy(x, scale, bias, groups=32, eps=1e-5, act="none"):
        norms[(tuple(x.shape), groups)] += 1
        return torch.empty(x.shape, device="meta", dtype=x.dtype)

    def attn_spy(q, k, v, **kw):
        attns[(tuple(q.shape), tuple(k.shape))] += 1
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    cfg, size, ctx, added = MODELS[model]
    if part == "vae":
        cfg, init = vae.SD_VAE_CONFIG, vae.init_state_dict
    else:
        init = unet.init_state_dict
    params = {k: torch.empty(v.shape, **META)
              for k, v in init(cfg, _ShapeRng()).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.conv_kernel, "conv3x3", conv_spy)
        mp.setattr(layers.gn_kernel, "group_norm_act", gn_spy)
        mp.setattr(unet, "dot_product_attention", attn_spy)
        mp.setattr(vae, "dot_product_attention", attn_spy)
        if part == "unet":
            added_cond = None if added is None else {
                "text_embeds": torch.empty(batch, added[0], **META),
                "time_ids": torch.empty(batch, added[1], device="meta")}
            unet.apply(params, torch.empty(batch, 4, size, size, **META), 981.0,
                       torch.empty(batch, 77, ctx, **META), cfg,
                       added_cond=added_cond)
        else:
            vae.decode(params, torch.empty(batch, 4, size, size, **META), cfg)
    return convs, norms, attns


def _kernel_attention(attns) -> collections.Counter:
    """The calls that route to the kernel on a CUDA tensor."""
    return collections.Counter({
        shapes: n for shapes, n in attns.items()
        if attention.routes_to_kernel(*shapes, torch.bfloat16, "cuda")})


# Launches per UNet forward / VAE decode on the kernel path; the attention
# kernel's calls by (B*H-free) q shape. These are chip_smoke.py's
# expectations for the two models.
@pytest.mark.parametrize("model,part,convs,norms,kernel_attn", [
    ("sd21", "unet", 49, 61, {(5, 9216, 64): 5, (10, 2304, 64): 5}),
    ("sdxl", "unet", 38, 46, {(10, 4096, 64): 10, (20, 1024, 64): 60}),
    ("sd21", "vae", 33, 30, {(1, 9216, 512): 1}),
    ("sdxl", "vae", 33, 30, {(1, 16384, 512): 1}),
])
def test_launches_per_call(model, part, convs, norms, kernel_attn):
    batch = 2 if part == "unet" else 1
    conv_calls, gn_calls, attns = _calls(model, part, batch)
    assert sum(conv_calls.values()) == convs
    assert sum(n for (shape, _), n in conv_calls.items() if shape[3] == 4) == 1
    assert sum(gn_calls.values()) == norms
    routed = _kernel_attention(attns)
    assert {(q[1], q[2], q[3]): n for (q, _), n in routed.items()} == kernel_attn
    assert all(q[0] == batch for q, _ in routed)


@pytest.mark.parametrize("model,routed", [("sd21", 10), ("sdxl", 70)])
@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_unet_attention_routing(model, routed, mode):
    """A UNet forward at batch 2 on int8 (W8A8) weights sends every call the
    kernel takes to its int8-QK^T variant: SD 2.1's 10 and SDXL's 70
    self-attentions at d=64, chip_smoke.py's W8A8 launches; on w8 weights
    none (the bf16 kernel)."""
    from uce_tpu_torch.models import quantize

    cfg, size, ctx, added = MODELS[model]
    params = quantize.quantize_params(
        {k: torch.empty(v.shape, **META)
         for k, v in unet.init_state_dict(cfg, _ShapeRng()).items()},
        quantize.UNET_SKIP, mode)
    calls = collections.Counter()

    def attn_spy(q, k, v, qk_int8=False, **kw):
        if attention.routes_to_kernel(q.shape, k.shape, torch.bfloat16, "cuda"):
            calls[(q.shape[-1], qk_int8)] += 1
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet, "dot_product_attention", attn_spy)
        mp.setattr(layers.conv_kernel, "conv3x3", lambda x, w, bias=None: torch.empty(
            (*x.shape[:3], w.shape[0]), device="meta", dtype=x.dtype))
        mp.setattr(layers.gn_kernel, "group_norm_act", lambda x, *a, **kw: torch.empty(
            x.shape, device="meta", dtype=x.dtype))
        unet.apply(params, torch.empty(2, 4, size, size, **META), 981.0,
                   torch.empty(2, 77, ctx, **META), cfg,
                   added_cond=None if added is None else {
                       "text_embeds": torch.empty(2, added[0], **META),
                       "time_ids": torch.empty(2, added[1], device="meta")})
    assert calls == {(64, mode == "int8"): routed}


@pytest.mark.parametrize("model", ["sd21", "sdxl"])
def test_unrouted_attention_stays_plain(model):
    """Cross-attention (77 keys) and SD 2.1's 24x24 and 12x12 levels (s=576,
    144) run the plain path, by the Sq >= 1024 rule."""
    _, _, attns = _calls(model, "unet", 2)
    routed = _kernel_attention(attns)
    plain = {q[2] for (q, k), _ in attns.items() if (q, k) not in routed}
    cross = sum(n for (q, k), n in attns.items() if k[2] == 77)
    assert cross == sum(n for (q, k), n in attns.items() if q[2] == k[2])
    assert plain == ({9216, 2304, 576, 144} if model == "sd21" else {4096, 1024})


@pytest.mark.parametrize("model,part,batch", [
    ("sd21", "unet", 2), ("sd21", "unet", 8), ("sdxl", "unet", 2),
    ("sdxl", "unet", 8), ("sd21", "vae", 1), ("sdxl", "vae", 1)])
def test_conv_plan_on_new_shapes(model, part, batch):
    """Every 3x3 conv: the latent-input conv (Cin = 4) takes the mma.sync
    kernel, every other one the wgmma kernel with 128-pixel rectangles
    whose TMA box edges stay within 256 elements; K splits are non-empty,
    cover the K steps once and never overfill the card; the tiles cover
    every pixel (widths 96, 48, 24, 12 are not powers of two)."""
    conv_calls, _, _ = _calls(model, part, batch)
    for (shape, cout), _ in conv_calls.items():
        b, h, w, cin = shape
        p = port_conv.plan(b, h, w, cin, cout, SMS)
        assert (p.variant == "mma") == (cin == 4)
        assert p.n_tiles == -(-cout // p.bn)
        if p.variant == "mma":
            assert p.splits == 1 and p.m_tiles * p.bn >= b * h * w
            continue
        assert p.nb * p.th * p.tw == port_conv.TILE_PIXELS
        assert max(p.nb, p.th, p.tw, port_conv.CHANNEL_STEP) <= 256
        assert p.m_tiles == -(-w // p.tw) * -(-h // p.th) * -(-b // p.nb)
        assert p.m_tiles * port_conv.TILE_PIXELS >= b * h * w
        assert p.ksteps == 9 * cin // port_conv.CHANNEL_STEP
        ranges = [range(z * p.per, min(p.ksteps, (z + 1) * p.per))
                  for z in range(p.splits)]
        assert all(len(r) > 0 for r in ranges)
        assert [k for r in ranges for k in r] == list(range(p.ksteps))
        assert p.splits == 1 or p.m_tiles * p.n_tiles * p.splits <= SMS


@pytest.mark.parametrize("model,part,batch", [
    ("sd21", "unet", 2), ("sd21", "unet", 8), ("sdxl", "unet", 2),
    ("sdxl", "unet", 8), ("sd21", "vae", 1), ("sdxl", "vae", 1)])
def test_group_norm_plan_on_new_shapes(model, part, batch):
    """Every GroupNorm gets a plan whose blocks cover each row and channel
    once, within 16 blocks a cluster and 227 KB of shared memory a block;
    the VAE's 768^2 and 1024^2 levels (up to 134M elements) stream."""
    _, gn_calls, _ = _calls(model, part, batch)
    for (shape, groups), _ in gn_calls.items():
        b, h, w, c = shape
        assert port_gn.supported_shape(shape, groups, torch.bfloat16)
        p = port_gn.plan(shape, groups)
        assert p.slab % (c // groups) == 0 and p.slab % 8 == 0 and c % p.slab == 0
        assert 1 <= p.cluster <= 16 and p.smem <= 227 * 1024
        cover = np.zeros((h * w, c // p.slab), np.int32)
        if p.schedule == "resident":
            assert p.blocks == b * (c // p.slab) * p.cluster
            for r in range(p.cluster):
                assert r * p.rows < h * w
                cover[r * p.rows:(r + 1) * p.rows] += 1
        else:
            assert p.blocks == b * -(-h * w // p.rows)
            for t in range(0, h * w, p.rows):
                cover[t:t + p.rows] += 1
        assert (cover == 1).all()
        if h >= 384:
            assert p.schedule == "stream"


@pytest.mark.parametrize("q_shape", [(2, 10, 4096, 64), (2, 20, 1024, 64),
                                     (2, 5, 9216, 64), (2, 10, 2304, 64),
                                     (8, 20, 1024, 64), (1, 1, 16384, 512),
                                     (1, 1, 9216, 512)])
def test_kernel_takes_new_attention_shapes(q_shape):
    assert port_sdk.supported_shape(q_shape, q_shape, torch.bfloat16)
    assert attention.routes_to_kernel(q_shape, q_shape, torch.bfloat16, "cuda")
    assert not attention.routes_to_kernel(q_shape, q_shape, torch.bfloat16, "cpu")
