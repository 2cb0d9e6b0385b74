"""The int8-QK^T attention (the port of uce_tpu's ``_kernel_qk8``): its K
pre-pass and plain version against uce_tpu's Pallas kernel in interpret
mode, and the routing that sends a W8A8 UNet's long self-attentions (and
nothing else) to it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.ops.attention import _xla_attention
from uce_tpu.ops.pallas import sd_attention as pallas_sdk
from uce_tpu_torch.models import quantize, unet as tunet, vae as tvae
from uce_tpu_torch.ops import attention as port_attn, kernels
from uce_tpu_torch.ops.kernels import sd_attention as port_sdk

# test_int8_qk_close_to_fp's cases, and a ragged Skv (uce_tpu keeps Skv
# whole per block, so its Sq must divide into blocks of 128).
CASES = [(2, 2, 256, 256, 40), (1, 4, 512, 512, 80), (2, 2, 256, 200, 40)]


def _inputs(b, h, sq, skv, d):
    """The draws of tests/test_sd_attention.py::test_int8_qk_close_to_fp, as
    (jax bf16, torch bf16) pairs holding the same values."""
    rng = np.random.default_rng(42)
    arrays = (rng.standard_normal((b, h, sq, d)),
              rng.standard_normal((b, h, skv, d)) + 0.3,
              rng.standard_normal((b, h, skv, d)))
    pairs = []
    for a in arrays:
        j = jnp.asarray(a, jnp.bfloat16)
        pairs.append((j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()))
    return pairs


def _uce_tpu_k_prepass(k):
    """uce_tpu/ops/pallas/sd_attention.py:138-141, which runs inside the
    jitted ``sd_attention`` and cannot be read back from it."""
    kf = k.astype(jnp.float32)
    kc = kf - jnp.mean(kf, axis=2, keepdims=True)
    ks = jnp.maximum(jnp.max(jnp.abs(kc), axis=3), 1e-6) / 127.0
    return np.asarray(jnp.round(kc / ks[..., None]).astype(jnp.int8)), np.asarray(ks)


@pytest.mark.parametrize("b,h,sq,skv,d", CASES)
def test_k_prepass_matches_uce_tpu(b, h, sq, skv, d):
    """torch.mean and jnp.mean reduce in different orders, so a rounding of
    ki may flip by one count on a tiny share of entries; nothing else may
    differ."""
    _, (kj, kt), _ = _inputs(b, h, sq, skv, d)
    ki, ks = port_sdk.quantize_k(kt)
    want_ki, want_ks = _uce_tpu_k_prepass(kj)
    # rows padded to whole 16-byte units (TMA's stride rule), pad columns zero
    dp = -(-d // 16) * 16
    assert ki.dtype == torch.int8 and tuple(ki.shape) == (b, h, skv, dp)
    assert tuple(ks.shape) == (b, h, skv) and port_sdk.k_cols(d) == dp
    assert not ki[..., d:].any()
    diff = np.abs(ki[..., :d].numpy().astype(np.int32) - want_ki.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(ks.numpy(), want_ks, rtol=1e-6)


@pytest.mark.parametrize("b,h,sq,skv,d", CASES)
def test_qk8_plain_version_matches_pallas_kernel(b, h, sq, skv, d):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(b, h, sq, skv, d)
    scale = d ** -0.5
    want = np.asarray(pallas_sdk.sd_attention(qj, kj, vj, scale, interpret=True,
                                              qk_int8=True), np.float32)
    kernels.reset_launches()
    got = port_sdk.sd_attention(qt, kt, vt, scale, qk_int8=True)  # CPU: plain
    assert not any(kernels.launches().values())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-3
    # and within test_int8_qk_close_to_fp's own bars of the bf16 attention
    err = np.abs(got - np.asarray(_xla_attention(qj, kj, vj, None, False, scale),
                                  np.float32))
    assert err.max() < 0.05 and err.mean() < 0.005


def _spy(monkeypatch):
    """Send the kernel route's device check to "cuda" on CPU tensors and
    count the calls of both plain versions."""
    calls = {"qk8": 0, "bf16": 0}
    route = port_attn.routes_to_kernel
    monkeypatch.setattr(port_attn, "routes_to_kernel",
                        lambda q, k, dtype, device, **kw: route(q, k, dtype,
                                                                "cuda", **kw))
    for name, attr in (("qk8", "sd_attention_qk8_reference"),
                       ("bf16", "sd_attention_reference")):
        fn = getattr(port_sdk, attr)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(port_sdk, attr, counted)
    return calls


def test_quantized_unet_routes_long_self_attention_to_qk8(monkeypatch):
    """A W8A8 UNet with head dim 40 at 32x32 latents: its three Sq = 1024
    self-attentions take the int8-QK^T path (the kernel's plain version on
    these CPU tensors) and nothing takes the bf16 one; cross-attention and
    the 16x16 level stay on the plain path. The output stays close to the
    float forward within tests/test_quant.py's bars for a quantized tiny
    UNet (int8 re-rounding makes any two W8A8 forwards that differ by a
    rounding somewhere differ by about their distance from float)."""
    cfg = tunet.UNetConfig(block_out_channels=(80, 160),
                           down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                           up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                           layers_per_block=1, cross_attention_dim=24,
                           attention_head_dim=2, norm_num_groups=8)
    flat = tunet.init_state_dict(cfg, np.random.default_rng(9), scale=0.05)
    params = quantize.quantize_params(
        tunet.load_params(flat, dtype=torch.bfloat16, device="cpu"))
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 7, 24)).astype(np.float32))
    want = tunet.apply(tunet.load_params(flat, device="cpu"), x, 500.0, ctx, cfg).double()
    calls = _spy(monkeypatch)
    got = tunet.apply(params, x.bfloat16(), 500.0, ctx.bfloat16(), cfg).double()
    assert calls == {"qk8": 3, "bf16": 0}
    assert (got - want).abs().max() / want.abs().max() < 0.1
    assert float((got * want).sum() / (got.norm() * want.norm())) > 0.995


def test_quantized_vae_keeps_bf16_attention(monkeypatch):
    """The VAE passes no qk_int8: quantized or not, its mid-block attention
    (one head, D = 40 here, Sq = 1024) takes the bf16 kernel's route."""
    cfg = tvae.VAEConfig(block_out_channels=(8, 40), layers_per_block=1,
                         norm_num_groups=4)
    flat = tvae.init_state_dict(cfg, np.random.default_rng(2), scale=0.1)
    params = quantize.quantize_params(
        tunet.load_params(flat, dtype=torch.bfloat16, device="cpu"), quantize.VAE_SKIP)
    lat = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 4, 32, 32)).astype(np.float32)).bfloat16()
    calls = _spy(monkeypatch)
    out = tvae.decode(params, lat, cfg)
    assert calls == {"qk8": 0, "bf16": 1}
    assert out.shape == (1, 3, 64, 64) and torch.isfinite(out.float()).all()


def test_magic_number_dequantize_is_exact():
    """The kernel's dequantize: for |acc| < 2^22 the float with the bits of
    acc + 0x4B400000 is 12582912 + acc exactly (|acc| <= 127^2 * 160 at the
    largest head dim)."""
    edge = [2 ** 21, -2 ** 21, 127 ** 2 * 160, -127 ** 2 * 160, 0, 1, -1]
    rand = np.random.default_rng(3).integers(-127 ** 2 * 160, 127 ** 2 * 160 + 1,
                                             10 ** 4)
    acc = torch.tensor(edge + rand.tolist(), dtype=torch.int32)
    got = (acc + 0x4B400000).view(torch.float32) - 12582912.0
    assert got.dtype == torch.float32
    assert torch.equal(got, acc.float())


def _kernel_order_emulation(q, ki, ks, v, scale, kv_tile):
    """fp32 emulation of the kernel's arithmetic order for one batch row at
    a time: exact int32 QK^T, y = fma(f, ks, -12582912 ks) with f the magic
    float of acc (the fma as an exact float64 product and sum rounded once),
    row max of y, p = exp2(fma(y, qc, -m qc)) with qc = qs * scale * log2(e),
    an online softmax over K/V tiles of ``kv_tile`` rows, P rounded to bf16,
    PV in fp32, normalised at the end."""
    d = q.shape[-1]
    ki = ki[..., :d]
    out = torch.empty_like(q)
    for i in range(q.shape[0]):
        qf = q[i].float()
        qs = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / 127.0
        qi = torch.round(qf / qs).to(torch.int64)
        acc = torch.matmul(qi, ki[i].to(torch.int64).transpose(-1, -2)).to(torch.int32)
        f = (acc + 0x4B400000).view(torch.float32).double()
        ksi = ks[i][:, None, :]
        nk = (-12582912.0 * ksi).float().double()   # the kernel's FMUL
        y = (f * ksi.double() + nk).float()
        qc = (qs * (scale * 1.4426950408889634)).float()
        m = torch.full(qs.shape, -float("inf"))
        l_sum = torch.zeros(qs.shape)
        o = torch.zeros(*q.shape[1:3], d)
        for t0 in range(0, y.shape[-1], kv_tile):
            yt = y[..., t0:t0 + kv_tile]
            m_new = torch.maximum(m, yt.amax(dim=-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * qc)
            p = torch.exp2(yt * qc - m_new * qc)
            l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.matmul(p.bfloat16().float(),
                                         v[i, :, t0:t0 + kv_tile].float())
            m = m_new
        out[i] = (o / l_sum).to(q.dtype)
    return out


@pytest.mark.parametrize("b,h,sq,skv,d", CASES + [(1, 2, 128, 256, 160)])
def test_kernel_order_emulation_matches_plain_version(b, h, sq, skv, d):
    """The kernel's logit order (IADD, two FFMAs, exp2, online softmax over
    its K/V tiles: 128 rows at d <= 80, 64 above) stays within the card's
    bound (rel L2 1e-2) of the plain version, and far inside it."""
    (_, qt), (_, kt), (_, vt) = _inputs(b, h, sq, skv, d)
    scale = d ** -0.5
    ki, ks = port_sdk.quantize_k(kt)
    want = port_sdk.sd_attention_qk8_reference(qt, ki, ks, vt, scale).float()
    got = _kernel_order_emulation(qt, ki, ks, vt, scale, 128 if d <= 80 else 64).float()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 5e-3, rel
    assert ((got - want).abs() <= 0.02 + 0.05 * want.abs()).all()
