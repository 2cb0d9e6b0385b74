"""FLUX.1-schnell's kernel calls at its published widths, enumerated by
running the models on meta tensors (shapes only, no weights): the joint
attention calls that route to the sd_attention kernel at
head dim 128 per DiT forward, the text encoders' attentions that stay
plain, and the 16-channel VAE decode's conv3x3 and group_norm_act calls on
the kernel path. These are chip_smoke.py's expected launches."""

import collections

import numpy as np
import pytest
import torch

from tests.test_torch_sdxl_sd21_shapes import _ShapeRng
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.diffusion import pipeline_flux
from uce_tpu_torch.models import clip_text, flux, layers, t5, vae
from uce_tpu_torch.ops import attention, kernels
from uce_tpu_torch.ops.kernels import conv3x3 as port_conv
from uce_tpu_torch.ops.kernels import qk_norm_rope as port_qk
from uce_tpu_torch.ops.kernels import sd_attention as port_sdk

SMS = 132  # an H100 SXM
META = dict(device="meta", dtype=torch.bfloat16)
FLUX_VAE = vae.FLUX_VAE_CONFIG
T5_TOKENS = 256  # schnell's max_sequence_length


def _dit_attention_calls(size: int, batch: int) -> collections.Counter:
    """(q shape, routed to the kernel) of every attention call of one DiT
    forward at ``size``^2 pixels."""
    cfg = flux.SCHNELL_CONFIG
    calls = collections.Counter()

    def attn_spy(q, k, v, **kw):
        routed = attention.routes_to_kernel(q.shape, k.shape, torch.bfloat16, "cuda")
        calls[(tuple(q.shape), routed)] += 1
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    params = {k: torch.empty(s, **META) for k, s in flux.state_dict_shapes(cfg).items()}
    lh = size // 8
    s_img = (lh // 2) ** 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flux, "dot_product_attention", attn_spy)
        out = flux.apply(params, torch.empty(batch, s_img, cfg.in_channels, **META),
                         torch.empty(batch, T5_TOKENS, cfg.joint_attention_dim, **META),
                         torch.empty(batch, cfg.pooled_projection_dim, **META),
                         torch.empty(batch, device="meta"),
                         pipeline_flux.make_img_ids(lh, lh), np.zeros((T5_TOKENS, 3)), cfg)
    assert tuple(out.shape) == (batch, s_img, cfg.in_channels)
    return calls


@pytest.mark.parametrize("size,batch,seq", [(1024, 1, 4352), (512, 1, 1280),
                                            (1024, 2, 4352)])
def test_dit_forward_routes_57_calls_to_the_d128_kernel(size, batch, seq):
    """19 double-stream and 38 single-stream blocks: 57 joint attentions per
    forward over 256 T5 tokens + the packed image, each long, mask-free
    self-attention at head dim 128, so every one takes the kernel."""
    calls = _dit_attention_calls(size, batch)
    assert dict(calls) == {((batch, 24, seq, 128), True): 57}
    assert port_sdk.supported_shape((batch, 24, seq, 128), (batch, 24, seq, 128),
                                    torch.bfloat16)


@pytest.mark.parametrize("kernel", ["sd_attention", "qk_norm_rope"])
def test_dit_forward_plain_impl_routes_nothing(monkeypatch, kernel):
    """With ``kernel`` switched off by ``ops.kernels.route`` (chip_smoke's
    reference forwards), a DiT forward at 1024 image tokens sends no call to
    that kernel's wrapper and the other kernel's calls go on; the routing
    is asked as on the card."""
    cfg = flux.FluxConfig(num_layers=1, num_single_layers=1)
    params = {k: torch.empty(s, **META) for k, s in flux.state_dict_shapes(cfg).items()}
    called = collections.Counter()
    route_attn, route_qk = attention.routes_to_kernel, port_qk.routes_to_kernel
    monkeypatch.setattr(attention, "routes_to_kernel", lambda q, k, dtype, device, **kw:
                        route_attn(q, k, dtype, "cuda", **kw))
    monkeypatch.setattr(port_qk, "routes_to_kernel", lambda dtype, device, head_dim:
                        route_qk(dtype, "cuda", head_dim))

    def attn_spy(q, k, v, scale, qk_int8=False):
        called["sd_attention"] += 1
        return torch.empty(q.shape, **META)

    def qk_spy(segments, cos, sin, head_dim=port_qk.HEAD_DIM, eps=port_qk.EPS):
        called["qk_norm_rope"] += 1
        b, _, width = segments[0][0].shape
        out = torch.empty(b, width // head_dim, cos.shape[0], head_dim, **META)
        return out, out
    monkeypatch.setattr(port_sdk, "sd_attention", attn_spy)
    monkeypatch.setattr(port_qk, "qk_norm_rope", qk_spy)

    def forward():
        flux.apply(params, torch.empty(1, 1024, 64, **META),
                   torch.empty(1, 8, 4096, **META), torch.empty(1, 768, **META),
                   torch.empty(1, device="meta"), pipeline_flux.make_img_ids(64, 64),
                   np.zeros((8, 3)), cfg)
    forward()
    assert called == {"sd_attention": 2, "qk_norm_rope": 2}
    called.clear()
    with kernels.route((kernel,)):
        forward()
    assert called == {k: 2 for k in ("sd_attention", "qk_norm_rope") if k != kernel}


def test_text_encoders_stay_plain(monkeypatch):
    """T5-XXL's attention carries the position bias, so it never calls the
    attention entry point (plain PyTorch, as in uce_tpu); CLIP-L's causal
    self-attention routes to the plain path by rule."""
    monkeypatch.setattr(port_sdk, "sd_attention",
                        lambda *a, **k: pytest.fail("a text encoder reached the kernel"))
    cfg = t5.T5_XXL_CONFIG
    sd = {k: torch.empty(s, **META) for k, s in t5.state_dict_shapes(cfg).items()}
    out = t5.encode_tokens(t5.convert_hf_state_dict(sd, cfg),
                           torch.zeros(2, T5_TOKENS, dtype=torch.long, device="meta"),
                           None, cfg)
    assert tuple(out.shape) == (2, T5_TOKENS, 4096)

    clip_calls = []

    def attn_spy(q, k, v, *, causal=False, **kw):
        clip_calls.append(attention.routes_to_kernel(q.shape, k.shape, torch.bfloat16,
                                                     "cuda", causal=causal))
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    ccfg = clip_text.SD14_TEXT_CONFIG  # CLIP-L, FLUX.1's text_encoder
    params = clip_text.convert_hf_state_dict(
        {k: torch.empty(v.shape, **META)
         for k, v in clip_text.init_state_dict(ccfg, _ShapeRng()).items()}, ccfg)
    monkeypatch.setattr(clip_text, "dot_product_attention", attn_spy)
    clip_text.encode_tokens(params, torch.zeros(2, 77, dtype=torch.long, device="meta"),
                            ccfg)
    assert clip_calls == [False] * 12


def _vae_calls():
    convs, norms, attns = (collections.Counter() for _ in range(3))

    def conv_spy(x, w, bias=None):
        convs[(tuple(x.shape), w.shape[0])] += 1
        return torch.empty((*x.shape[:3], w.shape[0]), device="meta", dtype=x.dtype)

    def gn_spy(x, scale, bias, groups=32, eps=1e-5, act="none"):
        norms[(tuple(x.shape), groups)] += 1
        return torch.empty(x.shape, device="meta", dtype=x.dtype)

    def attn_spy(q, k, v, **kw):
        attns[(tuple(q.shape), attention.routes_to_kernel(
            q.shape, k.shape, torch.bfloat16, "cuda"))] += 1
        return torch.empty(q.shape, device="meta", dtype=q.dtype)

    params = {k: torch.empty(v.shape, **META)
              for k, v in vae.init_state_dict(FLUX_VAE, _ShapeRng()).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.conv_kernel, "conv3x3", conv_spy)
        mp.setattr(layers.gn_kernel, "group_norm_act", gn_spy)
        mp.setattr(vae, "dot_product_attention", attn_spy)
        out = vae.decode(params, torch.empty(1, 16, 128, 128, **META), FLUX_VAE)
    assert tuple(out.shape) == (1, 3, 1024, 1024)
    return convs, norms, attns


def test_vae_decode_launches_at_1024():
    """The 16-channel decode at 1024^2 on the kernel path: 33 convs, of which
    conv_in (Cin = 16 -> 512 at 128^2) takes the mma.sync kernel and 32 the
    wgmma one, 30 GroupNorms, and the mid-block attention at s=16384, d=512."""
    convs, norms, attns = _vae_calls()
    assert sum(convs.values()) == 33 and sum(norms.values()) == 30
    mma = {k: n for k, n in convs.items()
           if port_conv.plan(*k[0], k[1], SMS).variant == "mma"}
    assert mma == {((1, 128, 128, 16), 512): 1}
    assert dict(attns) == {((1, 1, 16384, 512), True): 1}


def test_generate_launches_per_image():
    """One image of ``generate-flux`` at 1024^2, 4 steps: 4 DiT forwards
    (228 d=128 attention launches) and one decode."""
    calls = _dit_attention_calls(1024, 1)
    convs, norms, attns = _vae_calls()
    steps = 4
    assert steps * sum(n for (_, routed), n in calls.items() if routed) == 228
    assert (sum(convs.values()), sum(norms.values()), sum(attns.values())) == (33, 30, 1)
