"""The port's CLIP BPE tokenizer against transformers, and its CLIP text
encoder against uce_tpu.models.clip_text."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.snapshot import _write_tokenizer
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
