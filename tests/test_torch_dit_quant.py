"""The port's DiT quantization (models/quantize.py's FLUX_SKIP and HIDREAM_SKIP
over flat diffusers keys, the routed experts' storage-only arithmetic in
models/hidream.py) against uce_tpu's over its depth-stacked trees: the same
set of quantized weights, key for key, with bit-equal int8 payloads and
fp32 scales (one scale row per layer and per routed expert), from the same
bf16 values; and tiny FLUX and HiDream forwards in w8 and int8 on those
weights within the whole-network bar of tests/test_torch_quant.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import flux as jflux, hidream as jhd, quantize as jquantize
from uce_tpu_torch.models import convert, flux as tflux, hidream as thd
from uce_tpu_torch.models import quantize as tquantize
from uce_tpu_torch.ops import quant as tquant

# tests/test_quant.py's tiny FLUX, and tests/test_torch_hidream_model.py's
# tiny HiDream (3 routed experts, 2 active)
FLUX_TINY = dict(in_channels=16, num_layers=2, num_single_layers=2, attention_head_dim=8,
                 num_attention_heads=2, joint_attention_dim=16, pooled_projection_dim=24,
                 axes_dims_rope=(4, 2, 2))
HD_TINY = dict(patch_size=2, in_channels=4, out_channels=4, num_layers=2,
               num_single_layers=2, attention_head_dim=8, num_attention_heads=4,
               caption_channels=(12, 16), text_emb_dim=20, num_routed_experts=3,
               num_activated_experts=2, axes_dims_rope=(4, 2, 2),
               llama_layers=(0, 1, 2, 2), ffn_multiple_of=8)
# Whole quantized networks (tests/test_torch_quant.py): an activation within
# an ulp of a quantization boundary may round the other way on one side.
NET_REL_L2 = 1e-3

FAMILIES = {
    "flux": (jflux, tflux, FLUX_TINY, jquantize.FLUX_SKIP, tquantize.FLUX_SKIP,
             convert.flux_params),
    "hidream": (jhd, thd, HD_TINY, jquantize.HIDREAM_SKIP, tquantize.HIDREAM_SKIP,
                convert.hidream_params),
}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _is_q(v) -> bool:
    return tquant.is_quantized(v) or tquant.is_weight_only(v)


def _trees(family: str, dtype):
    """(uce_tpu config, port config, uce_tpu params, port params) from the
    same seeded weights, both in ``dtype``."""
    jmod, tmod, kw, _, _, carry = FAMILIES[family]
    cls = "FluxConfig" if family == "flux" else "HiDreamConfig"
    jcfg, tcfg = getattr(jmod, cls)(**kw), getattr(tmod, cls)(**kw)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                     jmod.init_params(jcfg, 0, scale=0.3))
    tparams = {k: v.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
               for k, v in carry(jparams, tcfg).items()}
    return jcfg, tcfg, jparams, tparams


# uce_tpu's float and quantized weights, by tests/test_quant.py's names
FLUX_FLOAT = ("x_embedder.weight", "context_embedder.weight", "proj_out.weight",
              "time_text_embed.text_embedder.linear_1.weight", "norm_out.linear.weight",
              "transformer_blocks.1.attn.norm_q.weight")
FLUX_QUANT = ("transformer_blocks.0.attn.to_q.weight", "transformer_blocks.1.norm1.linear.weight",
              "single_transformer_blocks.1.proj_out.weight")
HD_FLOAT = ("caption_projection.0.linear.weight", "caption_projection.4.linear.weight",
            "double_stream_blocks.0.block.ff_i.gate.weight", "final_layer.linear.weight",
            "x_embedder.proj.weight", "t_embedder.timestep_embedder.linear_1.weight")
HD_QUANT = ("double_stream_blocks.0.block.attn1.to_q.weight",
            "double_stream_blocks.1.block.ff_i.experts.2.w2.weight",
            "single_stream_blocks.1.block.ff_i.shared_experts.w1.weight",
            "double_stream_blocks.0.block.ff_t.w3.weight",
            "single_stream_blocks.0.block.adaLN_modulation.1.weight")


@pytest.mark.parametrize("family", ["flux", "hidream"])
@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantize_params_matches_uce_tpu(family, mode):
    """uce_tpu quantizes its stacked bf16 tree (per layer, per expert); the
    port its flat bf16 dict (per key): the same quantized keys, payloads and
    scales bit for bit; root-anchored ("proj_out",) skips only the final
    projection, "gate" only the MoE router; 1-D norm scales stay float."""
    _, tcfg, jparams, tparams = _trees(family, jnp.bfloat16)
    _, _, _, jskip, tskip, carry = FAMILIES[family]
    want = carry(jquantize.quantize_params(jparams, jskip, mode=mode), tcfg)
    got = tquantize.quantize_params(tparams, tskip, mode=mode)
    assert got.keys() == want.keys() == tparams.keys()
    quantized = sorted(k for k, v in got.items() if _is_q(v))
    assert quantized == sorted(k for k, v in want.items() if _is_q(v))
    kind = tquant.QKEY if mode == "int8" else tquant.WKEY
    for k in quantized:
        assert got[k].keys() == want[k].keys() == {kind, "scale"}
        assert got[k][kind].dtype == torch.int8 and got[k]["scale"].dtype == torch.float32
        assert torch.equal(got[k][kind], want[k][kind]), k
        assert torch.equal(got[k]["scale"], want[k]["scale"]), k
    floats, quants = (FLUX_FLOAT, FLUX_QUANT) if family == "flux" else (HD_FLOAT, HD_QUANT)
    assert not any(_is_q(got[k]) for k in floats)
    assert all(_is_q(got[k]) for k in quants)


def test_tuple_token_is_root_anchored():
    fn = tquantize.quantizer((("proj_out",), "gate"), "w8")
    w = torch.ones(4, 8)
    assert not _is_q(fn("proj_out.weight", w))
    assert _is_q(fn("single_transformer_blocks.3.proj_out.weight", w))
    assert not _is_q(fn("double_stream_blocks.0.block.ff_i.gate.weight", w))
    assert _is_q(fn("double_stream_blocks.0.block.ff_i.experts.0.w1.weight", w))
    assert not _is_q(fn("proj_out.bias", torch.ones(4)))
    with pytest.raises(ValueError, match="mode"):
        tquantize.quantizer((), "int4")


def _flux_forward(jcfg, tcfg, jparams, tparams):
    from uce_tpu.diffusion.pipeline_flux import make_img_ids

    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 16, 16)).astype(np.float32)
    t5e = (rng.standard_normal((2, 8, 16)) * 0.3).astype(np.float32)
    pooled = (rng.standard_normal((2, 24)) * 0.3).astype(np.float32)
    t = np.full((2,), 0.5, np.float32)
    img_ids, txt_ids = make_img_ids(8, 8), np.zeros((8, 3))
    want = np.asarray(jax.jit(lambda p: jflux.apply(
        p, jnp.asarray(lat), jnp.asarray(t5e), jnp.asarray(pooled), jnp.asarray(t),
        img_ids, txt_ids, jcfg))(jparams))
    got = tflux.apply(tparams, *(torch.as_tensor(a) for a in (lat, t5e, pooled, t)),
                      img_ids, txt_ids, tcfg)
    return got.numpy(), want


def _hidream_forward(jcfg, tcfg, jparams, tparams):
    from uce_tpu.diffusion.pipeline_flux import make_img_ids

    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 12, 16)).astype(np.float32)
    t5e = rng.standard_normal((2, 5, 12)).astype(np.float32)
    llama = rng.standard_normal((4, 2, 3, 16)).astype(np.float32)
    pooled = rng.standard_normal((2, 20)).astype(np.float32)
    t = np.array([700.0, 300.0], np.float32)
    img_ids = make_img_ids(6, 8)
    want = np.asarray(jax.jit(lambda p: jhd.apply(
        p, *(jnp.asarray(a) for a in (lat, t5e, llama, pooled, t)), img_ids, jcfg))(jparams))
    got = thd.apply(tparams, *(torch.as_tensor(a) for a in (lat, t5e, llama, pooled, t)),
                    img_ids, tcfg)
    return got.numpy(), want


@pytest.mark.parametrize("family", ["flux", "hidream"])
@pytest.mark.parametrize("mode", ["int8", "w8"])
def test_quantized_forward_matches_uce_tpu(family, mode, monkeypatch):
    """fp32 forwards on each side's own quantization of the same weights.
    HiDream int8: uce_tpu runs its routed experts storage-only (int8 weight
    cast to the activation dtype, scale on the output) and everything else
    int8 x int8; routed experts on the int8 product instead miss the bar."""
    jcfg, tcfg, jparams, tparams = _trees(family, jnp.float32)
    _, _, _, jskip, tskip, _ = FAMILIES[family]
    jq = jquantize.quantize_params(jparams, jskip, mode=mode)
    tq = tquantize.quantize_params(tparams, tskip, mode=mode)
    fwd = _flux_forward if family == "flux" else _hidream_forward
    got, want = fwd(jcfg, tcfg, jq, tq)
    float_got, _ = fwd(jcfg, tcfg, jparams, tparams) if mode == "w8" else (None, None)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_l2(got, want) <= NET_REL_L2
    if mode == "w8":  # weight-only int8 moves the network, within a few percent
        assert 1e-4 < _rel_l2(got, float_got) < 0.05
    if family == "hidream" and mode == "int8":
        monkeypatch.setattr(thd, "_expert_lin", thd._lin)  # routed experts on qlinear
        routed_qlinear, _ = fwd(jcfg, tcfg, jq, tq)
        assert _rel_l2(routed_qlinear, want) > 10 * NET_REL_L2


@pytest.mark.parametrize("family", ["flux", "hidream"])
def test_full_width_quantized_weights_fit_int_mm(family):
    """At FLUX.1's and HiDream-I1-Full's published widths (shapes only, on
    meta tensors) every weight the skips leave to quantize has K and N at
    least 16 and multiples of 8, as ``torch._int_mm`` takes them on CUDA
    (M, the adaLN products' batch, is padded); the quantized DiT is about
    half the bf16 one (FLUX 23.8 -> 12.0 GB, HiDream 34.2 -> 17.7 GB: its
    48 bf16 caption projections, the UCE edit targets, take 1.0 GB)."""
    if family == "flux":
        shapes, skip = tflux.state_dict_shapes(tflux.SCHNELL_CONFIG), tquantize.FLUX_SKIP
    else:
        shapes, skip = thd.state_dict_shapes(thd.I1_FULL_CONFIG), tquantize.HIDREAM_SKIP
    fn = tquantize.quantizer(skip, "int8")
    quantized = [s for k, s in shapes.items()
                 if _is_q(fn(k, torch.empty(s, device="meta")))]
    assert quantized and all(len(s) == 2 and min(s) >= 16 and s[0] % 8 == 0
                             and s[1] % 8 == 0 for s in quantized)
    bf16 = 2 * sum(int(np.prod(s)) for s in shapes.values())
    q_elems = sum(int(np.prod(s)) for s in quantized)
    int8 = bf16 - q_elems + 4 * sum(s[0] for s in quantized)
    want = {"flux": (23.8e9, 12.0e9), "hidream": (34.2e9, 17.7e9)}[family]
    assert abs(bf16 - want[0]) < 0.05e9 and abs(int8 - want[1]) < 0.1e9, (bf16, int8)
