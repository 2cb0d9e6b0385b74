"""CLIP byte-level BPE tokenizer read from ``vocab.json`` and ``merges.txt``.

Gives the ids and attention mask that transformers' ``CLIPTokenizer`` gives
for ``padding="max_length", truncation=True`` (without ftfy installed):
text cleanup and lower-casing, the CLIP pre-tokenizer pattern, byte-level
BPE with ``</w>`` word ends, bos/eos, and padding with the pad token. The
pattern's ``\\p{L}``/``\\p{N}`` classes are built from ``unicodedata`` so the
stdlib ``re`` module can run it.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata

import numpy as np

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP byte -> printable unicode character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _class(prefix: str) -> str:
    """A regex character class of every code point whose Unicode category
    starts with ``prefix`` (``L`` letters, ``N`` numbers)."""
    ranges, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b
                   else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in ranges)


@functools.lru_cache(maxsize=1)
def _pattern() -> re.Pattern:
    letters, numbers = _class("L"), _class("N")
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+",
        re.IGNORECASE)


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' BasicTokenizer (lower case, no accent stripping, no
    punctuation split), which CLIPTokenizer uses when ftfy is absent."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


class CLIPTokenizer:
    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 pad_token: str = EOS):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = vocab[BOS]
        self.eos_id = vocab[EOS]
        self.unk_id = vocab[EOS]
        self.pad_id = vocab[pad_token]
        self.cache = {BOS: BOS, EOS: EOS}

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        vocab = json.load(open(os.path.join(path, "vocab.json"), encoding="utf-8"))
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        pad = EOS
        special = os.path.join(path, "special_tokens_map.json")
        if os.path.exists(special):
            tok = json.load(open(special)).get("pad_token", EOS)
            pad = tok["content"] if isinstance(tok, dict) else tok
        return cls(vocab, merges, pad if pad in vocab else EOS)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _encode_text(self, text: str) -> list[int]:
        ids = []
        for token in _pattern().findall(basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder.get(t, self.unk_id)
                       for t in self.bpe(token).split(" "))
        return ids

    def encode(self, text: str) -> list[int]:
        """Token ids without bos/eos; the two special tokens written in
        the text map to their own ids."""
        ids = []
        for i, part in enumerate(re.split(f"({re.escape(BOS)}|{re.escape(EOS)})", text)):
            if i % 2:
                ids.append(self.encoder[part])
            elif part:
                ids.extend(self._encode_text(part))
        return ids

    def __call__(self, prompts, padding="max_length", max_length: int = 77,
                 truncation: bool = True, return_tensors="np"):
        """HF-style batch call: fixed-length ids and attention mask."""
        if padding != "max_length" or not truncation:
            raise ValueError("only padding='max_length' with truncation")
        prompts = [prompts] if isinstance(prompts, str) else list(prompts)
        ids = np.full((len(prompts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        for row, text in enumerate(prompts):
            toks = [self.bos_id] + self.encode(text)[:max_length - 2] + [self.eos_id]
            ids[row, :len(toks)] = toks
            mask[row, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
