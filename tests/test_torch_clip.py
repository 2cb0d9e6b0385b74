"""The port's CLIP BPE tokenizer against transformers (also with SDXL's "!"
pad token), and its CLIP text encoder against uce_tpu.models.clip_text
(quick_gelu, exact-erf gelu and tanh gelu towers, the text projection of
the pooled vector, both eos pooling rules)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.snapshot import _write_tokenizer
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import clip_text as jct
from uce_tpu_torch.models import clip_text as tct
from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from uce_tpu_torch.models.convert import clip_text_params

PROMPTS = [
    "a cat riding a bicycle",
    "",
    "Painting by Van Gogh, 1889!",
    "  lots   of\tspaces\nand CAPS  ",
    "cat's dog'll they're",
    "Ünïcode façade – naïve",
    "x" * 40,  # truncation
    "7 numbers 1234 and ½",
]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tok")
    _write_tokenizer(str(root), "tokenizer")
    return str(root / "tokenizer")


@pytest.fixture(scope="module")
def merges_dir(tmp_path_factory):
    """A vocabulary with real BPE merges, so the merge loop is exercised."""
    root = str(tmp_path_factory.mktemp("tok_merges"))
    vocab = _write_tokenizer(root, "tokenizer")
    merges = [("c", "a"), ("ca", "t</w>"), ("o", "g</w>"), ("d", "og</w>"),
              ("i", "n"), ("in", "g</w>"), ("a", "t</w>"), ("t", "h")]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    path = os.path.join(root, "tokenizer")
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path


@pytest.mark.parametrize("max_length", [16, 77])
@pytest.mark.parametrize("which", ["tok_dir", "merges_dir"])
def test_tokenizer_matches_transformers(request, which, max_length):
    from transformers import AutoTokenizer, CLIPTokenizer as HFCLIPTokenizer

    path = request.getfixturevalue(which)
    ours = CLIPTokenizer.from_pretrained(path)(
        PROMPTS, padding="max_length", max_length=max_length, truncation=True)
    for hf in (HFCLIPTokenizer.from_pretrained(path),
               AutoTokenizer.from_pretrained(path)):
        want = hf(PROMPTS, padding="max_length", max_length=max_length,
                  truncation=True, return_tensors="np")
        np.testing.assert_array_equal(ours["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(ours["attention_mask"],
                                      want["attention_mask"])


@pytest.mark.parametrize("eos", [None, 39])
def test_encode_tokens_matches_uce_tpu(eos):
    cfg_kw = dict(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=16, eos_token_id=eos)
    jcfg, tcfg = jct.CLIPTextConfig(**cfg_kw), tct.CLIPTextConfig(**cfg_kw)
    jparams = jct.init_params(np.random.default_rng(0), jcfg)
    ids = np.random.default_rng(1).integers(0, 40, (3, 16))
    j_last, j_pooled, j_hid = jct.encode_tokens(
        jparams, jnp.asarray(ids), jcfg, output_hidden_states=True)
    t_last, t_pooled, t_hid = tct.encode_tokens(
        clip_text_params(jparams, tcfg), torch.from_numpy(ids), tcfg,
        output_hidden_states=True)
    # fp32, 2 layers: roundoff only
    tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **tol)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), **tol)
    np.testing.assert_allclose(torch.stack(t_hid).numpy(), np.asarray(j_hid), **tol)


def test_hf_state_dict_conversion_roundtrip():
    """init_state_dict -> convert_hf_state_dict gives the same model as
    uce_tpu's converter on the same HF state dict."""
    cfg_kw = dict(vocab_size=30, hidden_size=16, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=32,
                  max_position_embeddings=8)
    tcfg, jcfg = tct.CLIPTextConfig(**cfg_kw), jct.CLIPTextConfig(**cfg_kw)
    sd = tct.init_state_dict(tcfg, np.random.default_rng(4))
    ids = np.random.default_rng(5).integers(0, 30, (2, 8))
    want = np.asarray(jct.encode_tokens(jct.convert_hf_state_dict(sd, jcfg),
                                        jnp.asarray(ids), jcfg)[0])
    got = tct.encode_tokens(
        tct.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                  tcfg), torch.from_numpy(ids), tcfg)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("act,projection,eos", [
    ("gelu", None, 39), ("gelu", 24, 2), ("quick_gelu", 24, None),
    ("gelu_new", None, 39), ("gelu_pytorch_tanh", 16, 2)])
def test_gelu_towers_and_projection_match_uce_tpu(act, projection, eos):
    """fp32 towers of each activation, with and without SDXL's text
    projection, under the literal eos id and the legacy sentinel 2 (argmax
    of the ids): last hidden state, every layer's output and the (projected)
    pooled vector."""
    cfg_kw = dict(vocab_size=40, hidden_size=32, num_hidden_layers=3,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=16, hidden_act=act,
                  projection_dim=projection, eos_token_id=eos)
    jcfg, tcfg = jct.CLIPTextConfig(**cfg_kw), tct.CLIPTextConfig(**cfg_kw)
    jparams = jct.init_params(np.random.default_rng(2), jcfg)
    ids = np.random.default_rng(3).integers(0, 39, (3, 16))
    ids[:, 7] = 39  # an eos token before the largest other id's position
    j_last, j_pooled, j_hid = jct.encode_tokens(
        jparams, jnp.asarray(ids), jcfg, output_hidden_states=True)
    t_last, t_pooled, t_hid = tct.encode_tokens(
        clip_text_params(jparams, tcfg), torch.from_numpy(ids), tcfg,
        output_hidden_states=True)
    tol = dict(atol=1e-5, rtol=1e-4)
    assert t_pooled.shape[-1] == (projection or 32)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), **tol)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), **tol)
    np.testing.assert_allclose(torch.stack(t_hid).numpy(), np.asarray(j_hid), **tol)


def test_gelu_is_the_exact_erf_form():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(tct._act("gelu")(x), torch.nn.functional.gelu(x))
    tanh = torch.nn.functional.gelu(x, approximate="tanh")
    assert torch.equal(tct._act("gelu_new")(x), tanh)
    assert not torch.equal(tct._act("gelu")(x), tanh)
    with pytest.raises(ValueError, match="unsupported activation"):
        tct._act("relu")


def test_projected_state_dict_conversion_matches_uce_tpu():
    """init_state_dict writes text_projection.weight for a projected tower;
    both converters read it into the same model."""
    cfg_kw = dict(vocab_size=30, hidden_size=16, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=32,
                  max_position_embeddings=8, hidden_act="gelu", projection_dim=12)
    tcfg, jcfg = tct.CLIPTextConfig(**cfg_kw), jct.CLIPTextConfig(**cfg_kw)
    sd = tct.init_state_dict(tcfg, np.random.default_rng(4))
    assert sd["text_projection.weight"].shape == (12, 16)
    assert tct.CLIPTextConfig.from_hf(tcfg.to_hf()) == tcfg
    ids = np.random.default_rng(5).integers(0, 30, (2, 8))
    want = jct.encode_tokens(jct.convert_hf_state_dict(sd, jcfg), jnp.asarray(ids), jcfg)
    got = tct.encode_tokens(
        tct.convert_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                  tcfg), torch.from_numpy(ids), tcfg)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)


def test_sdxl_tokenizer_2_pads_with_its_own_token(tmp_path):
    """SDXL's tokenizer_2 pads with "!" (its special_tokens_map.json); the
    port reads it from its own subfolder of the tiny SDXL snapshot, as
    transformers does, while tokenizer pads with the eos token."""
    from transformers import AutoTokenizer

    from tests.test_sdxl_pipeline import make_sdxl_snapshot
    from uce_tpu_torch.edit.sd import load_tokenizer

    snap = make_sdxl_snapshot(tmp_path)
    tok2 = os.path.join(snap, "tokenizer_2")
    vocab = json.load(open(os.path.join(tok2, "vocab.json")))
    vocab["!"] = len(vocab)
    json.dump(vocab, open(os.path.join(tok2, "vocab.json"), "w"))
    special = os.path.join(tok2, "special_tokens_map.json")
    json.dump(dict(json.load(open(special)), pad_token="!"), open(special, "w"))
    ours, ours_1 = load_tokenizer(snap, "tokenizer_2"), load_tokenizer(snap)
    assert ours.pad_id == vocab["!"] != ours_1.pad_id == vocab["<|endoftext|>"]
    kw = dict(padding="max_length", max_length=16, truncation=True)
    got = ours(PROMPTS, **kw)
    want = AutoTokenizer.from_pretrained(tok2)(PROMPTS, return_tensors="np", **kw)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert (got["input_ids"][1, 2:] == vocab["!"]).all()
