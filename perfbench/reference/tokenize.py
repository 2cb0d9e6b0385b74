"""A plain CLIP tokenizer over the benchmark's own vocabulary: CLIP's
49,408 ids and no merges, so a word is its byte-level characters, the last
one with ``</w>``."""

from __future__ import annotations

import re
import unicodedata

from perfbench.core.vocab import byte_chars

CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
       (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _clean(text: str) -> str:
    """CLIP's clean-up without ftfy: control characters dropped, white space
    made single spaces, CJK ideographs spaced apart, NFC, lower case."""
    out = []
    for ch in text:
        cat = unicodedata.category(ch)
        if ch in "\t\n\r " or cat == "Zs":
            out.append(" ")
        elif any(a <= ord(ch) <= b for a, b in CJK):
            out.append(f" {ch} ")
        elif not (ord(ch) in (0, 0xFFFD) or cat.startswith("C")):
            out.append(ch)
    return " ".join(w.lower() for w in unicodedata.normalize("NFC", "".join(out)).split())


def clip_words(text: str) -> list[str]:
    """CLIP's pre-tokenizer: contractions, runs of letters (Unicode L*), single
    digits (N*), runs of anything else but white space."""
    lets = "".join(sorted({re.escape(c) for c in text if unicodedata.category(c)[0] == "L"}))
    nums = "".join(sorted({re.escape(c) for c in text if unicodedata.category(c)[0] == "N"}))
    parts = [r"'s|'t|'re|'ve|'m|'ll|'d"] + [f"[{c}]+" if c == lets else f"[{c}]"
                                             for c in (lets, nums) if c]
    return re.findall("|".join(parts + [rf"[^\s{lets}{nums}]+"]), text)


def clip_ids(vocab: dict, text: str, length: int = 77):
    """(ids, mask), each a list of ``length`` ints, as CLIP's tokenizer pads
    and truncates them (bos, at most length - 2 tokens, eos; eos pads)."""
    chars = dict(byte_chars())
    toks = []
    for w in clip_words(_clean(text)):
        w = [chars[b] for b in w.encode("utf-8")]
        toks += [vocab[c] for c in w[:-1]] + [vocab[w[-1] + "</w>"]]
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    toks = [bos] + toks[:length - 2] + [eos]
    pad = length - len(toks)
    return toks + [eos] * pad, [1] * len(toks) + [0] * pad

