"""Tiny real-format tokenizer directories for the port's tokenizer.json
reader (uce_tpu_torch/models/hf_tokenizer.py), built in-process with the
``tokenizers`` library: a T5 v1.1-style Unigram (a Precompiled charsmap
built here, Metaspace, ``$A </s>``, 100 sentinels) and a Llama-3-style
byte-level BPE (the Llama-3 Split pattern, ByteLevel, ``ignore_merges``,
``<|begin_of_text|> $A``), each with a ``tokenizer_config.json`` laid out
as the published repositories lay theirs out."""

import base64
import csv
import glob
import json
import os
import struct

import numpy as np

LLAMA_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
                 r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
                  "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>",
                  "<|reserved_special_token_2|>", "<|start_header_id|>",
                  "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>"]
# full-width, circled, ligature, ideographic space, a decomposed e-acute, and
# two keys where one is a prefix of the other
CHARSMAP = {"Ａ": "A", "①": "1", "ﬁ": "fi", "　": " ", "é": "é",
            "\r": " ", "\r\n": "\n", "ǅ": "Dž"}


def corpus(n=3000):
    """Prompts of the repository's data/*.csv files, in file order."""
    root = os.path.join(os.path.dirname(__file__), "..", "data")
    out = []
    for path in sorted(glob.glob(os.path.join(root, "*.csv"))):
        with open(path, encoding="utf-8") as f:
            out += [r["prompt"] for r in csv.DictReader(f) if r.get("prompt")]
        if len(out) >= n:
            break
    return out[:n]


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """SentencePiece's precompiled charsmap of ``mapping``: a u32 trie size,
    a darts-clone double-array trie of the UTF-8 keys (each unit: label in
    bits 0-7, has-leaf bit 8, offset from bit 10; a leaf unit holds its
    value with bit 31 set), then the NUL-terminated replacements."""
    strings, values = b"", {}
    for key, rep in mapping.items():
        values[key.encode()] = len(strings)
        strings += rep.encode() + b"\0"
    root: dict = {}
    for key, value in values.items():
        node = root
        for c in key:
            node = node.setdefault(c, {})
        node[None] = value
    units, used, bases = {}, {0}, set()
    queue = [(root, 0, 0)]
    while queue:
        node, pos, label = queue.pop(0)
        labels = [c for c in node if c is not None] + ([0] if None in node else [])
        base = 256
        while base in bases or any((base ^ c) in used for c in labels):
            base += 1
        bases.add(base)
        used.update(base ^ c for c in labels)
        units[pos] = ((pos ^ base) << 10) | (int(None in node) << 8) | label
        if None in node:
            units[base] = node[None] | (1 << 31)
        queue += [(child, base ^ c, c) for c, child in node.items() if c is not None]
    array = [0] * ((max(units) // 256 + 1) * 256)
    for pos, unit in units.items():
        array[pos] = unit
    trie = struct.pack(f"<{len(array)}I", *array)
    return struct.pack("<I", len(trie)) + trie + strings


def _template(single, pair, specials):
    piece = {"A": {"Sequence": {"id": "A", "type_id": 0}},
             "B": {"Sequence": {"id": "B", "type_id": 1}}}
    return {"type": "TemplateProcessing",
            "single": [piece.get(p) or {"SpecialToken": {"id": p, "type_id": 0}} for p in single],
            "pair": [piece.get(p) or {"SpecialToken": {"id": p, "type_id": 0}} for p in pair],
            "special_tokens": specials}


def write_t5_tokenizer(path, vocab_size=400, texts=None, charsmap=CHARSMAP):
    """A T5 v1.1-style tokenizer.json: Unigram trained on ``texts``, the
    sentinels appended to the vocab in reverse (transformers' T5Converter),
    Precompiled + Replace(" {2,}", " ") normalizers, Metaspace and the
    ``$A </s>`` template."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.Unigram())
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always",
                                                 split=True)
    tok.train_from_iterator(texts or corpus(), trainers.UnigramTrainer(
        vocab_size=vocab_size, special_tokens=["<pad>", "</s>", "<unk>"], unk_token="<unk>"))
    spec = json.loads(tok.to_str())
    vocab = spec["model"]["vocab"]
    vocab += [[f"<extra_id_{i}>", 0.0] for i in range(99, -1, -1)]
    spec["added_tokens"] += [
        {"id": len(vocab) - 1 - i, "content": f"<extra_id_{i}>", "single_word": False,
         "lstrip": False, "rstrip": False, "normalized": False, "special": True}
        for i in range(100)]
    norms = [{"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]
    if charsmap:
        norms.insert(0, {"type": "Precompiled", "precompiled_charsmap":
                         base64.b64encode(build_charsmap(charsmap)).decode()})
    spec["normalizer"] = {"type": "Sequence", "normalizers": norms}
    spec["post_processor"] = _template(
        ["A", "</s>"], ["A", "</s>", "B", "</s>"],
        {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<pad>", "extra_ids": 100, "legacy": True,
                   "additional_special_tokens": [f"<extra_id_{i}>" for i in range(100)],
                   "model_max_length": 512, "clean_up_tokenization_spaces": True}, f)
    return len(vocab)


def write_llama_tokenizer(path, vocab_size=600, texts=None):
    """A Llama-3-style tokenizer.json: byte-level BPE trained on ``texts``
    with ``ignore_merges``, the Split + ByteLevel pre-tokenizers, special
    tokens after the vocab and the ``<|begin_of_text|> $A`` template; the
    config names no pad token (as Llama-3.1's)."""
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.train_from_iterator(texts or corpus(), trainers.BpeTrainer(
        vocab_size=vocab_size, initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    spec = json.loads(tok.to_str())
    spec["model"]["ignore_merges"] = True
    n = len(spec["model"]["vocab"])
    spec["added_tokens"] = [
        {"id": n + i, "content": c, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": True} for i, c in enumerate(LLAMA_SPECIALS)]
    spec["post_processor"] = {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": False,
         "use_regex": True},
        _template(["<|begin_of_text|>", "A"], ["<|begin_of_text|>", "A", "<|begin_of_text|>", "B"],
                  {"<|begin_of_text|>": {"id": "<|begin_of_text|>", "ids": [n],
                                         "tokens": ["<|begin_of_text|>"]}})]}
    spec["decoder"] = {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                       "use_regex": True}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<|begin_of_text|>", "eos_token": "<|eot_id|>",
                   "model_max_length": 131072, "clean_up_tokenization_spaces": True,
                   "model_input_names": ["input_ids", "attention_mask"]}, f)
    return n + len(LLAMA_SPECIALS)


def widen_embedding(folder, key, rows, seed=0):
    """Give a tiny snapshot encoder ``rows`` token embeddings (seeded), so
    that a real-format tokenizer's ids index it; its config follows."""
    from safetensors.numpy import load_file, save_file

    (path,) = glob.glob(os.path.join(folder, "*.safetensors"))
    sd = load_file(path)
    old = sd[key]
    new = np.random.default_rng(seed).standard_normal((rows, old.shape[1])) * old.std()
    new[:len(old)] = old
    sd[key] = new.astype(old.dtype)
    save_file(sd, path)
    cfg_path = os.path.join(folder, "config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["vocab_size"] = rows
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
