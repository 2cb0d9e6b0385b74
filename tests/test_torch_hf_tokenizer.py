"""The port's tokenizer.json reader (uce_tpu_torch/models/hf_tokenizer.py)
against ``transformers.AutoTokenizer`` on T5 v1.1-style and Llama-3-style
files built in-process (tests/torch_tokenizer_files.py): input_ids and
attention_mask equal at max_length 128, 256 and 512 with truncation and
max_length padding; the SentencePiece charsmap lookup equal to
``tokenizers.normalizers.Precompiled``'s; the T5 layouts of older and newer
``tokenizers`` releases; and edit-flux / edit-hidream on tiny snapshots whose
T5 and Llama directories hold such files, held to uce_tpu's edits at the
bars of tests/test_torch_edit_{flux,hidream}.py (rtol = atol = 1e-4 of the
targets' scale)."""

import json
import os
import re
import shutil

import numpy as np
import pytest

from tests import torch_tokenizer_files as files
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.models import hf_tokenizer

EXTRA = ["", "   ", "a  b   c", "  leading and trailing  ", "He's gone, THEY'LL see it's",
         "12345678 and 3.14159 and 2024", "東京の猫と犬、北京", "emoji 🐱🐈‍⬛ 👍🏻 🇫🇷",
         "x\x1cy\x1d z\x1e\x1f w\x1c\x1d end", "say <|eot_id|> then <extra_id_3> ok",
         "<extra_id_3>", "<|eot_id|>", "zzqx ÿþ ǅ ﬁne Ａ① é ĳ", "tab\there\nnew\r\nline",
         "café 　wide", "long " * 300, "Ωmega ∑ ≥ ½ ™ ©"]


def prompts():
    return files.corpus()[::97][:30] + EXTRA


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_tokenizers")
    files.write_t5_tokenizer(str(root / "t5"))
    files.write_llama_tokenizer(str(root / "llama"))
    return str(root / "t5"), str(root / "llama")


def _pair(path, llama=False):
    """AutoTokenizer's reading of ``path`` and the port's loader's; Llama's
    pads with eos on both sides, as uce_tpu's HiDream edit does."""
    from transformers import AutoTokenizer

    from uce_tpu_torch.edit.hidream import load_llama_tokenizer

    hf = AutoTokenizer.from_pretrained(path)
    if llama and hf.pad_token is None:
        hf.pad_token = hf.eos_token
    return hf, (load_llama_tokenizer(path) if llama
                else hf_tokenizer.load_tokenizer_dir(path, "T5"))


def _assert_same(hf, ours, texts, max_length):
    want = hf(texts, padding="max_length", max_length=max_length, truncation=True,
              return_tensors="np")
    got = ours(texts, padding="max_length", max_length=max_length, truncation=True,
               return_tensors="np")
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int64 and got[key].shape == (len(texts), max_length)
        bad = [t for t, a, b in zip(texts, want[key], got[key]) if not np.array_equal(a, b)]
        assert not bad, (key, bad[:3])


def test_precompiled_matches_tokenizers():
    """The darts-clone charsmap lookup, grapheme by grapheme (the shortest
    key that starts a cluster under 6 bytes replaces it whole), equals
    tokenizers' Precompiled normalizer."""
    from tokenizers.normalizers import Precompiled

    blob = files.build_charsmap(files.CHARSMAP)
    want = Precompiled(list(blob))
    ours = hf_tokenizer.CharsMap(blob)
    texts = EXTRA + ["é", "é́́", "Ａ́", "x\r\ny", "\r\n\r", "\r",
                     "؀a", "aःb", "각", "ǅ‍", "①②", "ﬁﬂ"]
    for text in texts:
        assert ours.normalize(text) == want.normalize_str(text), repr(text)
    # the lookup takes the first (shortest) key: "\r\n" becomes "\r"'s " "
    assert ours.normalize("a\r\nb") == "a b"


@pytest.mark.parametrize("max_length", [128, 256, 512])
def test_t5_unigram_matches_autotokenizer(tok_dirs, max_length):
    hf, ours = _pair(tok_dirs[0])
    assert type(hf).__name__ == "T5TokenizerFast"
    _assert_same(hf, ours, prompts(), max_length)


@pytest.mark.parametrize("max_length", [128, 256, 512])
def test_llama_bpe_matches_autotokenizer(tok_dirs, max_length):
    hf, ours = _pair(tok_dirs[1], llama=True)
    _assert_same(hf, ours, prompts(), max_length)
    assert ours.pad_id == hf.eos_token_id


def _legacy(spec):
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}


def _first(spec):
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                             "prepend_scheme": "first", "split": True}


def _whitespace_split(spec):
    spec["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]}


def _no_sentinels(spec):
    spec["model"]["vocab"] = spec["model"]["vocab"][:-100]
    spec["added_tokens"] = spec["added_tokens"][:3]


def _precompiled_alone(spec):
    spec["normalizer"] = spec["normalizer"]["normalizers"][0]


@pytest.mark.parametrize("edit", [_legacy, _first, _whitespace_split, _no_sentinels,
                                  _precompiled_alone], ids=lambda f: f.__name__.strip("_"))
def test_t5_layouts_match_autotokenizer(tok_dirs, tmp_path, edit):
    """Metaspace's add_prefix_space (before tokenizers 0.14) and its
    prepend_scheme "first"; WhitespaceSplit ahead of Metaspace; a file without
    the sentinels (T5TokenizerFast adds them after the vocab); Precompiled
    with no Replace after it."""
    path = str(tmp_path / "t5")
    shutil.copytree(tok_dirs[0], path)
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        spec = json.load(f)
    edit(spec)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f)
    if edit is _no_sentinels:
        cfg_path = os.path.join(path, "tokenizer_config.json")
        cfg = json.load(open(cfg_path))
        del cfg["additional_special_tokens"]
        json.dump(cfg, open(cfg_path, "w"))
    hf, ours = _pair(path)
    _assert_same(hf, ours, prompts(), 128)
    if edit is _no_sentinels:
        assert ours.token_to_id("<extra_id_0>") == hf.convert_tokens_to_ids("<extra_id_0>")


def test_llama_pattern_white_space_is_onigurumas():
    """The translated Llama-3 pattern splits as tokenizers' Split does on
    U+001C-U+001F; with Python's own \\s (which matches them) it does not."""
    from tokenizers import Regex, pre_tokenizers

    split = pre_tokenizers.Split(Regex(files.LLAMA_PATTERN), behavior="isolated")
    ours = re.compile(hf_tokenizer.translate_pattern(files.LLAMA_PATTERN))
    naive = re.compile(hf_tokenizer.translate_pattern(
        files.LLAMA_PATTERN.replace(r"\s", "@W@").replace(r"\S", "@N@"))
        .replace("@W@", r"\s").replace("@N@", r"\S"))
    text = "a\x1c\x1d b \x1e\x1f  c\x1c"
    want = [p for p, _ in split.pre_tokenize_str(text)]
    assert [m.group() for m in ours.finditer(text)] == want
    assert [m.group() for m in naive.finditer(text)] != want


@pytest.mark.parametrize("section,spec", [
    ("model", {"type": "WordPiece", "vocab": {}}),
    ("normalizer", {"type": "NFD"}),
    ("pre_tokenizer", {"type": "BertPreTokenizer"}),
    ("post_processor", {"type": "RobertaProcessing"})])
def test_other_component_types_raise_by_name(tok_dirs, section, spec):
    with open(os.path.join(tok_dirs[0], "tokenizer.json"), encoding="utf-8") as f:
        full = json.load(f)
    full[section] = spec
    with pytest.raises(NotImplementedError, match=spec["type"]):
        hf_tokenizer.HFTokenizer(full, {})


def _real_format_snapshot(make, root, t5_dirs, llama_dirs=()):
    """A tiny snapshot whose T5 (and Llama) tokenizers are tokenizer.json
    files; their encoders' embeddings widened to the tokenizers' ids."""
    snap = make(root)
    for tok_dir, enc_dir in t5_dirs:
        shutil.rmtree(os.path.join(snap, tok_dir))
        rows = files.write_t5_tokenizer(os.path.join(snap, tok_dir))
        files.widen_embedding(os.path.join(snap, enc_dir), "shared.weight", rows)
    for tok_dir, enc_dir in llama_dirs:
        path = os.path.join(snap, tok_dir)
        for name in ("vocab.json", "merges.txt", "special_tokens_map.json",
                     "tokenizer_config.json"):
            if os.path.exists(os.path.join(path, name)):
                os.remove(os.path.join(path, name))
        rows = files.write_llama_tokenizer(path)
        if enc_dir:
            files.widen_embedding(os.path.join(snap, enc_dir), "model.embed_tokens.weight", rows)
    return snap


def _edit_both(snap, tmp_path, monkeypatch, command, extra=()):
    from safetensors.numpy import load_file

    from uce_tpu.cli.main import main as jmain
    from uce_tpu_torch.cli.main import main as tmain

    monkeypatch.setenv("UCE_COMPILE_CACHE", "0")  # keep this worker's XLA cache as it was
    args = [command, "--model_id", snap, "--edit_concepts", "kelly mckernan; Tyler Edlin's",
            "--concept_type", "art", "--preserve_concepts", "van gogh", "--exp_name", "erase",
            *extra]
    assert jmain(args + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert tmain(args + ["--save_dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    want = load_file(str(tmp_path / "jax" / "erase.safetensors"))
    got = load_file(str(tmp_path / "torch" / "erase.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, rtol=1e-4, atol=1e-4)
    return sorted(got)


def test_edit_flux_reads_tokenizer_json_as_uce_tpu(tmp_path, monkeypatch):
    from tests.snapshot import make_flux_snapshot
    from uce_tpu_torch.edit.flux import load_t5_tokenizer

    snap = _real_format_snapshot(make_flux_snapshot, tmp_path / "snap",
                                 [("tokenizer_2", "text_encoder_2")])
    assert isinstance(load_t5_tokenizer(snap), hf_tokenizer.HFTokenizer)
    assert _edit_both(snap, tmp_path, monkeypatch, "edit-flux") == [
        "context_embedder.weight", "time_text_embed.text_embedder.linear_1.weight"]


def test_edit_hidream_reads_tokenizer_json_as_uce_tpu(tmp_path, monkeypatch):
    from tests.snapshot import make_hidream_snapshot
    from uce_tpu_torch.edit.hidream import load_llama_tokenizer

    snap = _real_format_snapshot(make_hidream_snapshot, tmp_path / "snap",
                                 [("tokenizer_3", "text_encoder_3")],
                                 [("text_encoder_4", "text_encoder_4"), ("tokenizer_4", None)])
    tok = load_llama_tokenizer(os.path.join(snap, "text_encoder_4"))
    assert isinstance(tok, hf_tokenizer.HFTokenizer)
    assert tok.pad_id == tok.token_to_id("<|eot_id|>")
    assert _edit_both(snap, tmp_path, monkeypatch, "edit-hidream",
                      ["--max_sequence_length", "16"]) == [
        f"caption_projection.{i}.linear.weight" for i in range(3)]
