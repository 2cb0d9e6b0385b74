"""The benchmark's T5 tokenizer files (FLUX.1's ``tokenizer_2``), written at
run time where the program reads them, as ``tokenizer.json`` with its
config files.

The published layout of T5 v1.1's 32,100 ids: SentencePiece's 32,000
pieces with ``<pad>`` 0, ``</s>`` 1 and ``<unk>`` 2 first, then the 100
sentinels, ``<extra_id_99>`` at 32,000 up to ``<extra_id_0>`` at 32,099.
The pieces are the word-start mark ``▁`` and one character each (printable
ASCII and Latin-1), and the rest are unused placeholders (private-use
characters): every word is its characters, with no merges, so a COCO
caption is still tens of tokens. The normalizer folds runs of spaces, as
the published file's last step does; the Metaspace pre-tokenizer and the
``$A </s>`` template are the published ones.
"""

from __future__ import annotations

import json
import os

PIECES = 32000
EXTRA_IDS = 100
SPECIALS = ("<pad>", "</s>", "<unk>")
SPACE = "▁"
CHARS = ([chr(c) for c in range(0x21, 0x7F)] + [chr(c) for c in range(0xA1, 0x100)])
PLACEHOLDER = 0xF0000  # the first of the unused pieces (plane 15, private use)


def pieces() -> list[str]:
    """The 32,000 SentencePiece pieces in id order."""
    head = list(SPECIALS) + [SPACE] + CHARS
    return head + [chr(PLACEHOLDER + i) for i in range(PIECES - len(head))]


def sentinels() -> list[tuple[int, str]]:
    """(id, token) of the 100 sentinels."""
    return [(PIECES + EXTRA_IDS - 1 - i, f"<extra_id_{i}>") for i in range(EXTRA_IDS)]


def t5_vocab() -> dict[str, int]:
    vocab = {p: i for i, p in enumerate(pieces())}
    vocab.update({t: i for i, t in sentinels()})
    return vocab


def write_t5(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True}
             for i, t in [(i, t) for i, t in enumerate(SPECIALS)] + sorted(sentinels())]
    meta = {"type": "Metaspace", "replacement": SPACE, "prepend_scheme": "always",
            "split": True}
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
            "pre_tokenizer": meta,
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"Sequence": {"id": "A", "type_id": 0}},
                                          {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                               "pair": [], "special_tokens": {
                                   "</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}},
            "decoder": meta,
            "model": {"type": "Unigram", "unk_id": 2, "byte_fallback": False,
                      "vocab": [[p, 0.0 if p in SPECIALS else -1.0] for p in pieces()]
                      + [[t, 0.0] for _, t in sorted(sentinels())]}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<pad>", "extra_ids": EXTRA_IDS, "legacy": True,
                   "additional_special_tokens": [t for _, t in reversed(sorted(sentinels()))],
                   "model_max_length": 512}, f)
    return path
