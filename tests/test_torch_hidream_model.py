"""The port's HiDream-I1 MoE DiT (uce_tpu_torch/models/hidream.py) against
uce_tpu's on the same seeded weights (uce_tpu's init_params carried across
by models/convert.py::hidream_params): the whole forward with the text
carry through two double- and two single-stream blocks, the dense MoE's
top-k gate, the full-width RMSNorm, and the config and state-dict
contracts. fp32 tolerances of tests/test_unet_cross_impl.py (rtol = atol
= 2e-4 for a module, 3e-4 for a whole network)."""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.models import convert, hidream as thd
from uce_tpu_torch.ops import kernels

TINY = dict(patch_size=2, in_channels=4, out_channels=4, num_layers=2,
            num_single_layers=2, attention_head_dim=8, num_attention_heads=4,
            caption_channels=(12, 16), text_emb_dim=20, num_routed_experts=3,
            num_activated_experts=2, axes_dims_rope=(4, 2, 2),
            llama_layers=(0, 1, 2, 2), ffn_multiple_of=8)


def _img_ids(lh, lw):
    from uce_tpu.diffusion.pipeline_flux import make_img_ids

    return make_img_ids(lh, lw)


@pytest.mark.parametrize("experts", [3, 0], ids=["moe", "swiglu"])
def test_apply_matches_uce_tpu(experts):
    import jax.numpy as jnp

    from uce_tpu.models import hidream as jhd

    kw = dict(TINY, num_routed_experts=experts)
    jcfg, tcfg = jhd.HiDreamConfig(**kw), thd.HiDreamConfig(**kw)
    jparams = jhd.init_params(jcfg, 0, scale=0.3)
    tparams = convert.hidream_params(jparams, tcfg)
    assert {k: tuple(v.shape) for k, v in tparams.items()} == thd.state_dict_shapes(tcfg)
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 12, 16)).astype(np.float32)
    t5e = rng.standard_normal((2, 5, 12)).astype(np.float32)
    llama = rng.standard_normal((4, 2, 3, 16)).astype(np.float32)
    pooled = rng.standard_normal((2, 20)).astype(np.float32)
    t = np.array([700.0, 300.0], np.float32)
    img_ids = _img_ids(6, 8)
    want = np.asarray(jhd.apply(jparams, jnp.asarray(lat), jnp.asarray(t5e),
                                jnp.asarray(llama), jnp.asarray(pooled), jnp.asarray(t),
                                img_ids, jcfg))
    args = (torch.as_tensor(lat), torch.as_tensor(t5e), torch.as_tensor(llama),
            torch.as_tensor(pooled), torch.as_tensor(t), img_ids, tcfg)
    got = thd.apply(tparams, *args)
    assert got.shape == (2, 12, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    # the attention kernel switched off is the same computation on the CPU
    with kernels.route(("sd_attention",)):
        assert torch.equal(thd.apply(tparams, *args), got)
    # the Llama streams reach the output: a single block's own stream too
    bumped = llama.copy()
    bumped[3] += 1.0
    moved = thd.apply(tparams, *args[:2], torch.as_tensor(bumped), *args[3:])
    assert (moved - got).abs().max() > 1e-3


def test_moe_gate_routes_top_k_unrenormalized():
    """k of E experts: the gate weights are the top-k softmax scores, zero
    elsewhere, not renormalized; the MoE output is their weighted sum of
    the experts' SwiGLU outputs plus the shared expert's, as uce_tpu's."""
    import jax.numpy as jnp

    from uce_tpu.models import hidream as jhd

    rng = np.random.default_rng(0)
    d, h, e = 8, 12, 4
    w = {f"ff.experts.{i}.{k}.weight": rng.standard_normal(s).astype(np.float32)
         for i in range(e) for k, s in (("w1", (h, d)), ("w3", (h, d)), ("w2", (d, h)))}
    w.update({f"ff.shared_experts.{k}.weight": rng.standard_normal(s).astype(np.float32)
              for k, s in (("w1", (h, d)), ("w3", (h, d)), ("w2", (d, h)))})
    w["ff.gate.weight"] = rng.standard_normal((e, d)).astype(np.float32)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {k: torch.as_tensor(v) for k, v in w.items()}
    gate = thd.moe_gate(p, "ff", torch.as_tensor(x), 2).numpy()
    logits = x @ w["ff.gate.weight"].T
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    assert ((gate > 0).sum(-1) == 2).all()
    top2 = np.sort(scores, -1)[..., -2:].sum(-1)
    np.testing.assert_allclose(gate.sum(-1), top2, rtol=1e-6)
    assert (gate.sum(-1) < 1).all()
    np.testing.assert_allclose(gate.max(-1), scores.max(-1), rtol=1e-6)

    cfg = thd.HiDreamConfig(num_routed_experts=e, num_activated_experts=2)
    got = thd._moe(p, "ff", torch.as_tensor(x), cfg).numpy()
    jp = {"gate": {"weight": jnp.asarray(w["ff.gate.weight"])},
          "experts": {k: {"weight": jnp.asarray(np.stack(
              [w[f"ff.experts.{i}.{k}.weight"].T for i in range(e)]))}
              for k in ("w1", "w2", "w3")},
          "shared": {k: {"weight": jnp.asarray(w[f"ff.shared_experts.{k}.weight"].T)}
                     for k in ("w1", "w2", "w3")}}
    want = np.asarray(jhd._moe(jp, jnp.asarray(x), 2))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_rms_full_matches_uce_tpu():
    """The full-width q/k RMSNorm, eps 1e-5 (FLUX's per-head one uses 1e-6)."""
    import jax.numpy as jnp

    from uce_tpu.models import hidream as jhd

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 7, 32)) * 1e-3).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    got = thd._rms_full(torch.as_tensor(x), torch.as_tensor(scale)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhd._rms_full(jnp.asarray(x),
                                                             jnp.asarray(scale))),
                               rtol=2e-4, atol=2e-4)
    loose = thd._rms_full(torch.as_tensor(x), torch.as_tensor(scale), eps=1e-6).numpy()
    assert np.abs(loose - got).max() > 1e-3  # eps matters at this scale


def test_config_from_hf_and_state_dict_contract():
    """from_hf with diffusers' null out_channels; to_hf round trip; the
    full model's swiglu widths and 17.1 B parameters; init_state_dict keys
    equal to uce_tpu's; convert_hf_state_dict accepting blocks without the
    HiDreamBlock wrapper and ModuleList to_out.0."""
    from uce_tpu.models import hidream as jhd

    cfg = thd.HiDreamConfig.from_hf({"in_channels": 16, "out_channels": None})
    assert cfg.out_channels == 16
    assert jhd.HiDreamConfig.from_hf({"in_channels": 16, "out_channels": None}) \
        .out_channels == 16
    full = thd.I1_FULL_CONFIG
    assert thd.HiDreamConfig.from_hf(full.to_hf()) == full
    assert len(full.llama_layers) == full.num_layers + full.num_single_layers == 48
    assert full.num_caption_projections == 49
    assert (full.swiglu_hidden(4 * full.inner_dim), full.swiglu_hidden(2 * full.inner_dim)
            ) == (6912, 3584)
    n = sum(int(np.prod(s)) for s in thd.state_dict_shapes(full).values())
    assert 17.0e9 < n < 17.2e9

    tcfg = thd.HiDreamConfig(**TINY)
    want = jhd.init_state_dict(jhd.HiDreamConfig(**TINY), np.random.default_rng(0))
    sd = thd.init_state_dict(tcfg, seed=1, device="cpu", dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in want.items()}
    assert torch.equal(sd["x_embedder.proj.bias"], torch.zeros(32))
    bare = {k.replace(".block.", ".").replace(".to_out.", ".to_out.0.")
            .replace(".to_out_t.", ".to_out_t.0."): v for k, v in sd.items()}
    assert "double_stream_blocks.0.attn1.to_out_t.0.weight" in bare
    back = thd.convert_hf_state_dict(bare)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
