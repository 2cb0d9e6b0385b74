"""The port's int8 quantization (ops/quant.py, models/quantize.py, the layer
dispatch, the quantized UNet and VAE) against uce_tpu's on the same int8
payloads, carried over by uce_tpu_torch.models.convert; also on SD 2.1's and
SDXL's tiny UNet topologies (linear projections, per-level heads, SDXL's
transformer depths and text_time conditioning). Their VAEs are SD's
topology, which the VAE cases cover."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import quantize as jquantize, unet as junet, vae as jvae
from uce_tpu.ops import quant as jquant
from uce_tpu_torch.models import layers, quantize as tquantize, unet as tunet, vae as tvae
from uce_tpu_torch.models.convert import nested_to_state_dict
from uce_tpu_torch.ops import quant as tquant

# fp32 paths that round the same int8 operands the same way: only the
# float sums around the exact int32 products differ.
OP_REL_L2 = 1e-5
# Whole quantized networks: an activation that lands within an ulp of a
# quantization boundary may round the other way on one side and move its
# int8 value by one count.
NET_REL_L2 = 1e-3


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _carry(key, qw):
    """One uce_tpu quantized leaf -> the port's weight at ``key``."""
    return nested_to_state_dict({key: {"weight": qw}})[f"{key}.weight"]


@pytest.mark.parametrize("shape", [(48, 24), (3, 3, 16, 12), (1, 1, 16, 12)])
@pytest.mark.parametrize("weight_only", [False, True])
def test_quantize_weight_matches_uce_tpu(shape, weight_only):
    """Same int8 payload as uce_tpu, scales within 1e-7 relative (linear
    [in, out] / HWIO there, [out, in] / OIHW here)."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.1
    want = _carry("m", jquant.quantize_weight(jnp.asarray(w), weight_only=weight_only))
    port_w = nested_to_state_dict({"m": {"weight": w}})["m.weight"]
    got = tquant.quantize_weight(port_w, weight_only=weight_only)
    kind = tquant.WKEY if weight_only else tquant.QKEY
    assert got.keys() == want.keys() == {kind, "scale"}
    assert got[kind].dtype == torch.int8 and got["scale"].shape == (shape[-1],)
    assert torch.equal(got[kind], want[kind])
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"].numpy(), rtol=1e-7)


@pytest.mark.parametrize("weight_only", [False, True])
def test_linear_matches_uce_tpu(weight_only):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 10, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 24)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(24) * 0.1).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), weight_only=weight_only)
    fn = jquant.wlinear if weight_only else jquant.qlinear
    want = np.asarray(fn(jnp.asarray(x), jw, jnp.asarray(b)))
    got = layers.linear(torch.from_numpy(x), _carry("m", jw), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), want) <= OP_REL_L2


def test_qlinear_integer_path_exact():
    """tests/test_quant.py's case: integer inputs whose rows and columns
    reach amax 127 quantize losslessly, so the output is the exact product,
    bit for bit."""
    rng = np.random.default_rng(42)
    x = rng.integers(-127, 128, (3, 16)).astype(np.float32)
    x[:, 0] = 127.0
    w = rng.integers(-127, 128, (8, 16)).astype(np.float32)  # [out, in]
    w[:, 0] = 127.0
    got = tquant.qlinear(torch.from_numpy(x),
                         tquant.quantize_weight(torch.from_numpy(w)))
    want = np.asarray(jquant.qlinear(jnp.asarray(x),
                                     jquant.quantize_weight(jnp.asarray(w.T))))
    np.testing.assert_array_equal(got.numpy(), x @ w.T)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weight_only", [False, True])
@pytest.mark.parametrize("ksize", [3, 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1])
def test_conv2d_matches_uce_tpu(weight_only, ksize, stride, padding):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    k = (rng.standard_normal((ksize, ksize, 16, 12)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(12) * 0.1).astype(np.float32)
    jk = jquant.quantize_weight(jnp.asarray(k), weight_only=weight_only)
    fn = jquant.wconv2d if weight_only else jquant.qconv2d
    want = np.asarray(fn(jnp.asarray(x), jk, jnp.asarray(b), stride=stride,
                         padding=padding))
    got = layers.conv2d(_nchw(x), _carry("m", jk), torch.from_numpy(b),
                        stride=stride, padding=padding)
    assert got.shape == (want.shape[0], want.shape[3], *want.shape[1:3])
    assert _rel_l2(_nhwc(got), want) <= OP_REL_L2


def test_quantized_conv_skips_conv_kernel_and_takes_channels_last(monkeypatch):
    """A quantized 3x3 conv on bf16 activations still runs qconv2d (never
    the conv3x3 kernel), on channels_last input as on NCHW."""
    from uce_tpu_torch.ops.kernels import conv3x3 as ck

    monkeypatch.setattr(ck, "conv3x3_reference", lambda *a: pytest.fail("kernel"))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 8, 8)).astype(np.float32))
    w = tquant.quantize_weight(torch.from_numpy(
        rng.standard_normal((12, 16, 3, 3)).astype(np.float32)))
    nchw = layers.conv2d(x.bfloat16(), w)
    cl = layers.conv2d(x.bfloat16().contiguous(memory_format=torch.channels_last), w)
    assert nchw.dtype == torch.bfloat16 and torch.equal(nchw, cl)
    assert torch.equal(nchw, tquant.qconv2d(x.bfloat16(), w))


def test_concat_weights():
    rng = np.random.default_rng(4)
    ws = [torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
          for _ in range(3)]
    for weight_only in (False, True):
        qs = [tquant.quantize_weight(w, weight_only=weight_only) for w in ws]
        cat = tquant.concat_weights(qs)
        kind = tquant.WKEY if weight_only else tquant.QKEY
        assert cat[kind].shape == (24, 16) and cat["scale"].shape == (24,)
        assert torch.equal(cat[kind][8:16], qs[1][kind])
        assert tquant.concat_weights([ws[0], qs[1], qs[2]]) is None
    assert torch.equal(tquant.concat_weights(ws), torch.cat(ws))
    assert tquant.concat_weights([tquant.quantize_weight(ws[0]),
                                  tquant.quantize_weight(ws[1], True)]) is None


TINY_UNET = dict(block_out_channels=(8, 16),
                 down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                 up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
                 layers_per_block=1, cross_attention_dim=32,
                 attention_head_dim=2, norm_num_groups=4)
SD_TOPOLOGY = dict(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                   cross_attention_dim=24, attention_head_dim=2, norm_num_groups=4)
TINY_VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)


@pytest.mark.parametrize("model,cfg_kw,skip", [
    ("unet", TINY_UNET, "UNET_SKIP"),
    ("unet", SD_TOPOLOGY, "UNET_SKIP"),
    ("vae", dict(TINY_VAE, block_out_channels=(8, 16, 32, 32)), "VAE_SKIP"),
])
@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantize_params_matches_uce_tpu(model, cfg_kw, skip, mode):
    """The same set of quantized keys, the same payloads and counts."""
    tmod = tunet if model == "unet" else tvae
    config = tunet.UNetConfig if model == "unet" else tvae.VAEConfig
    flat = tmod.init_state_dict(config(**cfg_kw), np.random.default_rng(5))
    jparams = jquantize.quantize_params(junet.nest_state_dict(flat),
                                        getattr(jquantize, skip), mode=mode)
    want = nested_to_state_dict(jparams)
    got = tquantize.quantize_params(tunet.load_params(flat, device="cpu"),
                                    getattr(tquantize, skip), mode=mode)
    is_q = lambda v: tquant.is_quantized(v) or tquant.is_weight_only(v)  # noqa: E731
    quantized = sorted(k for k, v in got.items() if is_q(v))
    assert quantized == sorted(k for k, v in want.items() if is_q(v))
    for k in quantized:
        assert all(torch.equal(got[k][n], want[k][n]) for n in got[k])
    nq, nw = tquantize.count_quantized(got)
    assert (nq, nw) == jquantize.count_quantized(jparams)
    assert nq == len(quantized) > 10


# tests/test_sd2_pipeline.py's and tests/test_sdxl_pipeline.py's tiny UNets
SD21_TOPOLOGY = dict(TINY_UNET, use_linear_projection=True, attention_head_dim=(2, 4))
SDXL_TOPOLOGY = dict(block_out_channels=(8, 16),
                     down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                     up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
                     layers_per_block=1, cross_attention_dim=40, attention_head_dim=(2, 4),
                     transformer_layers_per_block=(1, 2), use_linear_projection=True,
                     norm_num_groups=4, addition_embed_type="text_time",
                     addition_time_embed_dim=8, projection_class_embeddings_input_dim=64)
SD2X = {"sd21": SD21_TOPOLOGY, "sdxl": SDXL_TOPOLOGY}


@pytest.mark.parametrize("model", ["sd21", "sdxl"])
@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantize_params_sd21_sdxl_match_uce_tpu(model, mode):
    """As test_quantize_params_matches_uce_tpu on SD 2.1's and SDXL's
    topologies; SDXL's add_embedding stays float (UNET_SKIP)."""
    flat = tunet.init_state_dict(tunet.UNetConfig(**SD2X[model]),
                                 np.random.default_rng(5))
    jparams = jquantize.quantize_params(junet.nest_state_dict(flat), jquantize.UNET_SKIP,
                                        mode=mode)
    want = nested_to_state_dict(jparams)
    got = tquantize.quantize_params(tunet.load_params(flat, device="cpu"),
                                    tquantize.UNET_SKIP, mode=mode)
    is_q = lambda v: tquant.is_quantized(v) or tquant.is_weight_only(v)  # noqa: E731
    quantized = sorted(k for k, v in got.items() if is_q(v))
    assert quantized == sorted(k for k, v in want.items() if is_q(v))
    for k in quantized:
        assert all(torch.equal(got[k][n], want[k][n]) for n in got[k])
    assert tquantize.count_quantized(got) == jquantize.count_quantized(jparams)
    assert any("proj_in" in k for k in quantized)  # the linear projections
    assert (model == "sdxl") == any(k.startswith("add_embedding") for k in got)
    assert not any(k.startswith("add_embedding") for k in quantized)


@pytest.mark.parametrize("model", ["sd21", "sdxl"])
@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_unet_sd21_sdxl_match_uce_tpu(model, mode):
    """uce_tpu's quantized UNet on SD 2.1's and SDXL's topologies (SDXL with
    its text_time conditioning), carried over, against its forward (fp32)."""
    jcfg, tcfg = junet.UNetConfig(**SD2X[model]), tunet.UNetConfig(**SD2X[model])
    jparams = jquantize.quantize_params(junet.nest_state_dict(
        junet.init_state_dict(jcfg, np.random.default_rng(42), scale=0.1)), mode=mode)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, tcfg.cross_attention_dim)).astype(np.float32)
    added = None
    if model == "sdxl":
        added = {"text_embeds": rng.standard_normal((2, 16)).astype(np.float32),
                 "time_ids": np.array([[32, 32, 0, 0, 32, 32]] * 2, np.float32)}
    want = np.asarray(jax.jit(lambda p, x, c, a: junet.apply(
        p, x, jnp.asarray(500.0), c, jcfg, added_cond=a))(
        jparams, jnp.asarray(x), jnp.asarray(ctx),
        None if added is None else {k: jnp.asarray(v) for k, v in added.items()}))
    got = tunet.apply(nested_to_state_dict(jparams), _nchw(x), 500.0,
                      torch.from_numpy(ctx), tcfg,
                      added_cond=None if added is None else {
                          k: torch.from_numpy(v) for k, v in added.items()})
    assert _rel_l2(_nhwc(got), want) <= NET_REL_L2


def test_quantize_params_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tquantize.quantize_params({}, mode="int4")


@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_unet_matches_uce_tpu(mode):
    """The tiny UNet of tests/test_quant.py, quantized by uce_tpu and carried
    over, against uce_tpu's quantized forward (fp32)."""
    jcfg, tcfg = junet.UNetConfig(**TINY_UNET), tunet.UNetConfig(**TINY_UNET)
    jparams = jquantize.quantize_params(junet.nest_state_dict(
        junet.init_state_dict(jcfg, np.random.default_rng(42))), mode=mode)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x, t, c: junet.apply(p, x, t, c, jcfg))(
        jparams, jnp.asarray(x), jnp.asarray(500.0), jnp.asarray(ctx)))
    got = tunet.apply(nested_to_state_dict(jparams), _nchw(x), 500.0,
                      torch.from_numpy(ctx), tcfg)
    assert _rel_l2(_nhwc(got), want) <= NET_REL_L2


@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_vae_decode_matches_uce_tpu(mode):
    jcfg, tcfg = jvae.VAEConfig(**TINY_VAE), tvae.VAEConfig(**TINY_VAE)
    flat = tvae.init_state_dict(tcfg, np.random.default_rng(2), scale=0.1)
    jparams = jquantize.quantize_params(junet.nest_state_dict(flat),
                                        jquantize.VAE_SKIP, mode=mode)
    lat = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jvae.decode(p, z, jcfg))(jparams,
                                                                    jnp.asarray(lat)))
    got = tvae.decode(nested_to_state_dict(jparams), _nchw(lat), tcfg)
    assert _rel_l2(_nhwc(got), want) <= NET_REL_L2


def test_overlay_edit_into_quantized_slot_takes_pipeline_dtype():
    """A float edit replaces a quantized slot in the requested dtype (the
    pipeline's); its shape is checked against the payload."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    edit = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    params = {"attn.to_k.weight": tquant.quantize_weight(w, weight_only=True),
              "attn.to_v.weight": tquant.quantize_weight(w)}
    for dtype in (torch.float32, torch.bfloat16):
        out = tunet.overlay_edits(params, {"attn.to_k.weight": edit,
                                           "attn.to_v.weight": edit}, dtype=dtype)
        for key in ("attn.to_k.weight", "attn.to_v.weight"):
            assert out[key].dtype == dtype
            assert torch.equal(out[key], edit.to(dtype))
    assert tunet.overlay_edits(params, {"attn.to_k.weight": edit})[
        "attn.to_k.weight"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        tunet.overlay_edits(params, {"attn.to_k.weight": edit.T})
