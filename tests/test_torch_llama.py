"""The port's Llama encoder (uce_tpu_torch/models/llama.py, HiDream-I1's
text_encoder_4) against uce_tpu's on the same seeded weights (uce_tpu's
init_params carried across by models/convert.py::llama_params): every
hidden state, with and without the llama3 RoPE scaling, under a padding
mask, and the final-normed last entry; the config and state-dict
contracts. fp32 tolerances of tests/test_unet_cross_impl.py (rtol = atol
= 3e-4 for a whole network)."""

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.models import convert, llama as tllama

LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
TINY = dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0)


def _configs(rope_scaling):
    from uce_tpu.models import llama as jllama

    hf = dict(TINY, rope_scaling=rope_scaling)
    return jllama.LlamaConfig.from_hf(hf), tllama.LlamaConfig.from_hf(hf)


@pytest.mark.parametrize("rope_scaling", [None, LLAMA3], ids=["plain_rope", "llama3"])
def test_rope_frequencies_match_uce_tpu(rope_scaling):
    from uce_tpu.models import llama as jllama

    jcfg, tcfg = _configs(rope_scaling)
    got = tllama.rope_frequencies(tcfg)
    np.testing.assert_array_equal(got, jllama.rope_frequencies(jcfg))
    if rope_scaling:  # the low frequencies are divided by the factor
        plain = tllama.rope_frequencies(_configs(None)[1])
        assert got[-1] == pytest.approx(plain[-1] / 8.0) and (got <= plain).all()


@pytest.mark.parametrize("rope_scaling", [None, LLAMA3], ids=["plain_rope", "llama3"])
def test_hidden_states_match_uce_tpu(rope_scaling):
    """Every hidden state (embeddings, out_1, out_2, then the normed out_3)
    of a padded batch."""
    import jax.numpy as jnp

    from uce_tpu.models import llama as jllama

    jcfg, tcfg = _configs(rope_scaling)
    jparams = jllama.init_params(np.random.default_rng(0), jcfg)
    tparams = convert.llama_params(jparams, tcfg)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 99, size=(2, 12))
    mask = np.ones((2, 12), np.int64)
    mask[1, 7:] = 0  # right padding, as the tokenizers pad
    want = np.asarray(jllama.encode_tokens(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                           jcfg))
    got = tllama.encode_tokens(tparams, torch.as_tensor(ids), torch.as_tensor(mask), tcfg)
    assert got.shape == want.shape == (4, 2, 12, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    # the last entry is the final RMSNorm of the last layer's output
    np.testing.assert_allclose(
        tllama.final_norm(tparams, got[-1], tcfg).numpy(),
        np.asarray(jllama.final_norm(jparams, jnp.asarray(want[-1]), jcfg)),
        rtol=3e-4, atol=3e-4)


def test_padding_mask_changes_only_later_rows():
    """Left padding hides keys: rows after the pad change, and a fully
    unmasked batch equals no mask at all."""
    _, tcfg = _configs(None)
    sd = tllama.init_state_dict(tcfg, seed=2, scale=0.2, device="cpu", dtype=torch.float32)
    params = tllama.convert_hf_state_dict(sd, tcfg)
    ids = torch.full((1, 8), 5)
    full = torch.ones(1, 8, dtype=torch.long)
    left = full.clone()
    left[0, :4] = 0
    h_full = tllama.encode_tokens(params, ids, full, tcfg)
    assert torch.equal(h_full, tllama.encode_tokens(params, ids, None, tcfg))
    h_left = tllama.encode_tokens(params, ids, left, tcfg)
    assert (h_full[-1, :, 4:] - h_left[-1, :, 4:]).abs().max() > 0


def test_config_and_state_dict_contract():
    """LlamaConfig reads and writes config.json as uce_tpu reads it;
    state_dict_shapes is the key contract uce_tpu's converter and
    tests/snapshot.py use (``model.`` prefix, no lm_head); Llama-3.1-8B is
    7.5 B parameters without its head."""
    from uce_tpu.models import llama as jllama

    cfg = tllama.LLAMA31_8B_CONFIG
    hf = cfg.to_hf()
    assert tllama.LlamaConfig.from_hf(hf) == cfg
    jcfg = jllama.LlamaConfig.from_hf(hf)
    assert {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__} == cfg.__dict__
    assert dict(cfg.rope_scaling)["rope_type"] == "llama3" and cfg.dh == 128
    n = sum(int(np.prod(s)) for s in tllama.state_dict_shapes(cfg).values())
    assert 7.50e9 < n < 7.51e9
    _, tiny = _configs(None)
    sd = tllama.init_state_dict(tiny, seed=1, device="cpu", dtype=torch.float32)
    jparams = jllama.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()},
                                           jllama.LlamaConfig.from_hf(tiny.to_hf()))
    assert jparams["layers"]["q"].shape == (3, 32, 32)
    assert torch.equal(sd["model.norm.weight"], torch.ones(32))
    assert torch.equal(sd["model.layers.2.mlp.down_proj.weight"], tllama.init_state_dict(
        tiny, seed=1, device="cpu", dtype=torch.float32)["model.layers.2.mlp.down_proj.weight"])
