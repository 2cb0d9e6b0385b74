"""Hugging Face ``tokenizer.json`` reader in pure Python.

Gives the ids and attention mask that ``transformers.AutoTokenizer`` gives
for ``padding="max_length", truncation=True`` on the two layouts the FLUX
and HiDream snapshots ship:

* T5 v1.1 (FLUX's ``tokenizer_2``, HiDream's ``tokenizer_3``): a
  ``Precompiled`` normalizer (SentencePiece's charsmap, optionally followed
  by ``Replace(" {2,}", " ")``), a ``Metaspace`` pre-tokenizer, a
  ``Unigram`` model decoded by Viterbi, an ``$A </s>`` template and the
  ``<extra_id_N>`` sentinels;
* Llama-3.1 (HiDream's ``tokenizer_4``): a ``Split`` pre-tokenizer with
  the Llama-3 pattern, ``ByteLevel``, a byte-level ``BPE`` with
  ``ignore_merges`` and a ``<|begin_of_text|> $A`` template.

Every step follows the ``tokenizers`` library: added tokens are split out
of the raw text first, each remaining piece is normalized and
pre-tokenized on its own, and truncation leaves room for the template's
tokens. Any other component type raises ``NotImplementedError`` naming it.
The patterns' ``\\p{L}``/``\\p{N}``/``\\s`` classes are spelled out from
``unicodedata`` so that the stdlib ``re`` runs them: Python's ``\\s`` also
matches U+001C-U+001F, which Oniguruma's (the White_Space property) does
not.
"""

from __future__ import annotations

import base64
import functools
import heapq
import json
import os
import re
import struct
import unicodedata

import numpy as np

from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer, _class, bytes_to_unicode

# the White_Space property (Oniguruma's and Rust's \\s), as a class body
WHITE_SPACE = r"\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"
SPM_SPACE = "▁"


@functools.lru_cache(maxsize=2)
def _classes() -> dict[str, str]:
    return {"L": _class("L"), "N": _class("N")}


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern as the stdlib ``re`` reads it: ``\\p{L}``,
    ``\\p{N}``, ``\\s`` and ``\\S`` become explicit classes, inside a
    bracket expression or outside."""
    cls = _classes()
    out, i, depth = [], 0, 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt in "pP" and pattern.startswith("{", i + 2):
                end = pattern.index("}", i)
                name = pattern[i + 3:end]
                if name not in cls:
                    raise NotImplementedError(f"pattern class \\p{{{name}}}")
                body = cls[name]
                neg = nxt == "P"
                i = end + 1
            elif nxt in "sS":
                body, neg, i = WHITE_SPACE, nxt == "S", i + 2
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if depth:
                if neg:
                    raise NotImplementedError("a negated class inside brackets")
                out.append(body)
            else:
                out.append(f"[{'^' if neg else ''}{body}]")
            continue
        if ch == "[" and not depth:
            depth = 1
            out.append(ch)
            i += 1
            if pattern.startswith("^", i):
                out.append("^")
                i += 1
            if pattern.startswith("]", i):  # a literal ']' first in the class
                out.append("\\]")
                i += 1
            continue
        if ch == "]" and depth:
            depth = 0
        out.append(ch)
        i += 1
    return "".join(out)


# --- SentencePiece's precompiled charsmap ---------------------------------

def _gcb(ch: str) -> str:
    """The Grapheme_Cluster_Break classes the charsmap lookup can see.

    A cluster of 6 or more UTF-8 bytes is looked up char by char, so only
    the rules that join short clusters matter: CR LF, Control, Extend, ZWJ,
    SpacingMark, Prepend and the Hangul syllable rules. The emoji and
    regional-indicator rules (GB11-GB13) join 4-byte code points only and
    are left out."""
    return _GCB_CACHE.get(ch) or _gcb_compute(ch)


_GCB_CACHE: dict[str, str] = {}
_EXTEND_EXTRA = {0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5,
                 0x0CD6, 0x0D3E, 0x0D57, 0x0DCF, 0x0DDF, 0x1B35, 0x200C, 0x302E,
                 0x302F, 0xFF9E, 0xFF9F, 0x1133E, 0x11357, 0x114B0, 0x114BD,
                 0x115AF, 0x11930, 0x1D165, *range(0x1D16E, 0x1D173),
                 *range(0x1F3FB, 0x1F400), *range(0xE0020, 0xE0080)}
_PREPEND = {*range(0x0600, 0x0606), 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2,
            0x0D4E, 0x110BD, 0x110CD, 0x111C2, 0x111C3, 0x1193F, 0x11941,
            0x11A3A, *range(0x11A84, 0x11A8A), 0x11D46, 0x11F02}
_NOT_SPACING = {0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064,
                *range(0x1067, 0x106E), 0x1083, *range(0x1087, 0x108D), 0x108F,
                0x109A, 0x109B, 0x109C, 0x1A61, 0x1A63, 0x1A64, 0xAA7B, 0xAA7D,
                0x11720, 0x11721}


def _gcb_compute(ch: str) -> str:
    cp, cat = ord(ch), unicodedata.category(ch)
    if ch == "\r":
        cls = "CR"
    elif ch == "\n":
        cls = "LF"
    elif cp == 0x200D:
        cls = "ZWJ"
    elif cp in _EXTEND_EXTRA or cat in ("Mn", "Me"):
        cls = "Extend"
    elif cp in _PREPEND:
        cls = "Prepend"
    elif cat in ("Cc", "Zl", "Zp", "Cs") or cat == "Cf":
        cls = "Control"
    elif (cat == "Mc" and cp not in _NOT_SPACING) or cp in (0x0E33, 0x0EB3):
        cls = "SpacingMark"
    elif 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        cls = "L"
    elif 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        cls = "V"
    elif 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        cls = "T"
    elif 0xAC00 <= cp <= 0xD7A3:
        cls = "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    else:
        cls = "Any"
    _GCB_CACHE[ch] = cls
    return cls


def _joined(a: str, b: str) -> bool:
    if a == "CR" and b == "LF":
        return True
    if a in ("Control", "CR", "LF") or b in ("Control", "CR", "LF"):
        return False
    if a == "L" and b in ("L", "V", "LV", "LVT"):
        return True
    if a in ("LV", "V") and b in ("V", "T"):
        return True
    if a in ("LVT", "T") and b == "T":
        return True
    return b in ("Extend", "ZWJ", "SpacingMark") or a == "Prepend"


def graphemes(text: str) -> list[str]:
    """Extended grapheme clusters (UAX #29, the rules of ``_gcb``)."""
    out, start, prev = [], 0, None
    for i, ch in enumerate(text):
        cls = _gcb(ch)
        if prev is not None and not _joined(prev, cls):
            out.append(text[start:i])
            start = i
        prev = cls
    if text:
        out.append(text[start:])
    return out


class CharsMap:
    """SentencePiece's precompiled charsmap: a little-endian ``u32`` trie
    size, a darts-clone double-array trie of UTF-8 keys, then the
    NUL-terminated replacement strings the trie's values point into.

    As ``tokenizers``' ``Precompiled`` normalizer (the ``spm_precompiled``
    crate) runs it: each grapheme cluster under 6 bytes is replaced whole
    when a key is a prefix of it, by the first (shortest) such key; other
    clusters, and clusters no key starts, are looked up char by char."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.strings = blob[4 + size:]
        self._memo: dict[str, str | None] = {}

    def _first_value(self, key: bytes) -> int | None:
        units, n = self.units, len(self.units)
        if not n:
            return None
        unit = units[0]
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= n:
                return None
            unit = units[pos]
            if unit & 0x800000FF != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return units[pos] & 0x7FFFFFFF
        return None

    def transform(self, chunk: str) -> str | None:
        if chunk in self._memo:
            return self._memo[chunk]
        value = self._first_value(chunk.encode("utf-8"))
        out = None
        if value is not None:
            end = self.strings.find(b"\0", value)
            out = self.strings[value:end if end >= 0 else None].decode("utf-8")
        self._memo[chunk] = out
        return out

    def normalize(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                rep = self.transform(g)
                if rep is not None:
                    out.append(rep)
                    continue
            for ch in g:
                rep = self.transform(ch)
                out.append(ch if rep is None else rep)
        return "".join(out)


# --- components ------------------------------------------------------------

def _regex(pattern: dict) -> re.Pattern:
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    return re.compile(translate_pattern(pattern["Regex"]))


def _normalizer(spec: dict | None):
    """A str -> str function for a ``normalizer`` entry."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def run(text):
            for step in steps:
                text = step(text)
            return text
        return run
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        if not blob:
            return lambda text: text
        return CharsMap(base64.b64decode(blob)).normalize
    if kind == "Replace":
        pat, content = _regex(spec["pattern"]), spec["content"]
        return lambda text: pat.sub(lambda _: content, text)
    raise NotImplementedError(f"tokenizer.json normalizer type {kind!r}")


# A split is (text, at_start): at_start marks the piece that begins the raw
# text, which Metaspace's "first" prepend scheme needs.

def _pre_tokenizer(spec: dict | None):
    """A function from one split to its list of splits."""
    if spec is None:
        return lambda split: [split]
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(split):
            splits = [split]
            for step in steps:
                splits = [s for sp in splits for s in step(sp)]
            return splits
        return run
    if kind == "Metaspace":
        rep = spec.get("replacement", SPM_SPACE)
        if "prepend_scheme" in spec:
            scheme, split_on = spec["prepend_scheme"], spec.get("split", True)
        else:  # the layout before tokenizers 0.14
            scheme, split_on = ("always" if spec.get("add_prefix_space", True)
                                else "never"), True

        def metaspace(split):
            text, at_start = split
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and at_start)):
                text = rep + text
            if not split_on:
                return [(text, at_start)]
            parts = re.split(f"(?={re.escape(rep)})", text)
            return [(p, at_start and i == 0) for i, p in enumerate(parts) if p]
        return metaspace
    if kind == "WhitespaceSplit":  # ahead of Metaspace in older T5 files
        words = re.compile(f"[^{WHITE_SPACE}]+")

        def whitespace_split(split):
            text, at_start = split
            return [(m.group(), at_start and m.start() == 0) for m in words.finditer(text)]
        return whitespace_split
    if kind == "Split":
        if spec.get("invert") or spec["behavior"] != "Isolated":
            raise NotImplementedError("tokenizer.json Split other than Isolated")
        pat = _regex(spec["pattern"])

        def split_fn(split):
            text, at_start = split
            out, last = [], 0
            for m in pat.finditer(text):
                if m.start() > last:
                    out.append((text[last:m.start()], at_start and last == 0))
                if m.end() > m.start():
                    out.append((m.group(), at_start and m.start() == 0))
                last = m.end()
            if last < len(text):
                out.append((text[last:], at_start and last == 0))
            return out
        return split_fn
    if kind == "ByteLevel":
        if spec.get("add_prefix_space") or spec.get("use_regex", True):
            raise NotImplementedError("tokenizer.json ByteLevel with add_prefix_space "
                                      "or use_regex")
        table = bytes_to_unicode()
        return lambda split: [("".join(table[b] for b in split[0].encode("utf-8")),
                               split[1])]
    raise NotImplementedError(f"tokenizer.json pre_tokenizer type {kind!r}")


def _template(spec: dict | None) -> tuple[list[int], list[int]]:
    """(ids before, ids after) the sequence of a single-sequence template."""
    if spec is None:
        return [], []
    kind = spec["type"]
    if kind == "Sequence":
        before, after = [], []
        for proc in spec["processors"]:
            b, a = _template(proc)
            before, after = before + b, after + a
        return before, after
    if kind == "ByteLevel":  # offsets only
        return [], []
    if kind != "TemplateProcessing":
        raise NotImplementedError(f"tokenizer.json post_processor type {kind!r}")
    before, after, seen = [], [], False
    for piece in spec["single"]:
        if "Sequence" in piece:
            seen = True
            continue
        ids = spec["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
        (after if seen else before).extend(ids)
    return before, after


class _Unigram:
    """SentencePiece Unigram: Viterbi over the piece log-probabilities, as
    ``tokenizers``' ``encode_optimized`` (ties keep the first path found,
    a char no piece covers is an unknown at min score - 10, runs of
    unknowns fuse into one)."""

    def __init__(self, spec: dict):
        if spec.get("byte_fallback"):
            raise NotImplementedError("tokenizer.json Unigram with byte_fallback")
        self.pieces: dict[str, tuple[int, float]] = {}
        for i, (piece, score) in enumerate(spec["vocab"]):
            self.pieces[piece] = (i, float(score))
        self.size = len(spec["vocab"])
        self.unk_id = spec.get("unk_id")
        self.unk_score = min((s for _, s in spec["vocab"]), default=0.0) - 10.0
        self.max_len = max((len(p) for p in self.pieces), default=1)

    def token_id(self, token: str) -> int | None:
        hit = self.pieces.get(token)
        return None if hit is None else hit[0]

    def tokenize(self, text: str) -> list[int]:
        n, pieces = len(text), self.pieces
        score = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        for i in range(n):
            base, single = score[i], False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                hit = pieces.get(text[i:j])
                if hit is None:
                    continue
                cand = base + hit[1]
                if start[j] < 0 or cand > score[j]:
                    score[j], start[j], ids[j] = cand, i, hit[0]
                if j == i + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("a Unigram tokenizer without unk_id met an unknown char")
                cand = base + self.unk_score
                if start[i + 1] < 0 or cand > score[i + 1]:
                    score[i + 1], start[i + 1], ids[i + 1] = cand, i, self.unk_id
        out, end, unk_end = [], n, None
        while end > 0:
            begin = start[end]
            if ids[end] == self.unk_id:
                if unk_end is None:
                    unk_end = end
            else:
                if unk_end is not None:
                    out.append(self._lookup(text[end:unk_end]))
                    unk_end = None
                out.append(ids[end])
            end = begin
        if unk_end is not None:
            out.append(self._lookup(text[0:unk_end]))
        return out[::-1]

    def _lookup(self, token: str) -> int:
        hit = self.pieces.get(token)
        return self.unk_id if hit is None else hit[0]


class _BPE:
    """Byte-level BPE as ``tokenizers``' ``BPE`` model: with
    ``ignore_merges`` a pre-token found in the vocab is taken whole; else
    the merges are applied lowest rank first, leftmost first among equal
    ranks."""

    def __init__(self, spec: dict):
        for key in ("continuing_subword_prefix", "end_of_word_suffix", "unk_token"):
            if spec.get(key):
                raise NotImplementedError(f"tokenizer.json BPE with {key}")
        if spec.get("byte_fallback") or spec.get("dropout"):
            raise NotImplementedError("tokenizer.json BPE with byte_fallback or dropout")
        self.vocab: dict[str, int] = spec["vocab"]
        self.size = len(self.vocab)
        self.ignore_merges = spec.get("ignore_merges", False)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        vocab = self.vocab
        for rank, merge in enumerate(spec["merges"]):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[a + b])
        self._cache: dict[str, list[int]] = {}

    def token_id(self, token: str) -> int | None:
        return self.vocab.get(token)

    def tokenize(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            out = [self.vocab[word]]
        else:
            out = self._merge(word)
        if len(self._cache) < 100_000:
            self._cache[word] = out
        return out

    def _merge(self, word: str) -> list[int]:
        # a char outside the vocab is dropped, as tokenizers drops it
        # without an unk token (a byte-level vocab holds all 256)
        syms = [self.vocab[ch] for ch in word if ch in self.vocab]
        n, merges = len(syms), self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        alive = [True] * n
        heap = []  # (rank, position, merged id)
        for i in range(n - 1):
            hit = merges.get((syms[i], syms[i + 1]))
            if hit is not None:
                heap.append((hit[0], i, hit[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            hit = merges.get((syms[pos], syms[right]))
            if hit is None or hit[1] != new:
                continue
            syms[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                hit = merges.get((syms[prev[pos]], new))
                if hit is not None:
                    heapq.heappush(heap, (hit[0], prev[pos], hit[1]))
            if nxt[pos] < n:
                hit = merges.get((new, syms[nxt[pos]]))
                if hit is not None:
                    heapq.heappush(heap, (hit[0], pos, hit[1]))
        return [s for s, a in zip(syms, alive) if a]


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "Unigram":
        return _Unigram(spec)
    if kind == "BPE":
        return _BPE(spec)
    raise NotImplementedError(f"tokenizer.json model type {kind!r}")


def _token_name(value) -> str | None:
    if isinstance(value, dict):
        return value.get("content")
    return value


T5_CLASSES = ("T5Tokenizer", "T5TokenizerFast")


class HFTokenizer:
    """A ``tokenizer.json`` tokenizer with the HF batch call signature."""

    def __init__(self, spec: dict, config: dict | None = None):
        config = dict(config or {})
        self.model = _model(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.prefix_ids, self.suffix_ids = _template(spec.get("post_processor"))
        self.added: dict[str, int] = {}
        self._raw, self._normalized = [], []  # contents split before / after normalizing
        for tok in spec.get("added_tokens", []):
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word"):
                raise NotImplementedError("tokenizer.json added token with lstrip, rstrip "
                                          "or single_word")
            self._add(tok["content"], tok["id"], tok.get("normalized", not tok["special"]))
        # transformers adds the special tokens its config names, and T5's
        # sentinels when the files lack them (T5TokenizerFast.__init__)
        additional = list(config.get("additional_special_tokens") or [])
        if config.get("tokenizer_class") in T5_CLASSES:
            if not any("<extra_id_" in str(_token_name(t)) for t in additional):
                additional += [f"<extra_id_{i}>" for i in range(config.get("extra_ids", 100))]
        named = [config[k] for k in ("bos_token", "eos_token", "unk_token", "pad_token")
                 if config.get(k) is not None]
        for tok in named + additional:
            name = _token_name(tok)
            if name is not None and name not in self.added:
                self._add(name, self._new_id(name), False)
        self.pad_token = _token_name(config.get("pad_token"))
        self.eos_token = _token_name(config.get("eos_token"))
        self.padding_side = config.get("padding_side", "right")
        self.truncation_side = config.get("truncation_side", "right")
        self._split_raw = self._matcher(self._raw)
        self._split_normalized = self._matcher(self._normalized)

    def _add(self, content, tid, normalized):
        self.added[content] = tid
        (self._normalized if normalized else self._raw).append(content)

    def _new_id(self, name: str) -> int:
        tid = self.model.token_id(name)
        if tid is not None:
            return tid
        top = max(self.added.values(), default=None)
        return self.model.size if top is None or top < self.model.size else top + 1

    def _matcher(self, contents):
        if not contents:
            return None
        alts = "|".join(re.escape(c) for c in sorted(contents, key=len, reverse=True))
        return re.compile(alts)

    @classmethod
    def from_pretrained(cls, path: str) -> "HFTokenizer":
        """Read ``path/tokenizer.json`` with ``tokenizer_config.json`` and
        ``special_tokens_map.json`` (which wins where both name a token)."""
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    config.update({k: v for k, v in json.load(f).items() if v is not None})
        return cls(spec, config)

    @property
    def pad_id(self) -> int:
        if self.pad_token is None:
            raise ValueError("the tokenizer has no pad token to pad with")
        return self.token_to_id(self.pad_token)

    def token_to_id(self, token: str) -> int:
        tid = self.added.get(token)
        return self.model.token_id(token) if tid is None else tid

    def _split(self, pieces, matcher):
        """Split the (text, start, id) pieces without an id around matches."""
        if matcher is None:
            return pieces
        out = []
        for text, start, tid in pieces:
            if tid is not None:
                out.append((text, start, tid))
                continue
            last = 0
            for m in matcher.finditer(text):
                lo, hi = m.start(), m.end()
                if lo > last:
                    out.append((text[last:lo], start + last, None))
                out.append((text[lo:hi], start + lo, self.added[m.group()]))
                last = hi
            if last < len(text):
                out.append((text[last:], start + last, None))
        return out

    def encode(self, text: str) -> list[int]:
        """Token ids without the template's tokens."""
        pieces = self._split([(text, 0, None)], self._split_raw)
        if self.normalize is not None:
            pieces = [(p if tid is not None else self.normalize(p), s, tid)
                      for p, s, tid in pieces]
            pieces = [x for x in pieces if x[0]]
        pieces = self._split(pieces, self._split_normalized)
        ids = []
        for text_, start, tid in pieces:
            if tid is not None:
                ids.append(tid)
                continue
            for word, _ in self.pre_tokenize((text_, start == 0)):
                if word:
                    ids.extend(self.model.tokenize(word))
        return ids

    def __call__(self, prompts, padding="max_length", max_length: int = 512,
                 truncation: bool = True, return_tensors="np"):
        """HF-style batch call: fixed-length ids and attention mask."""
        if padding != "max_length" or not truncation:
            raise ValueError("only padding='max_length' with truncation")
        prompts = [prompts] if isinstance(prompts, str) else list(prompts)
        ids = np.full((len(prompts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(prompts), max_length), np.int64)
        room = max(max_length - len(self.prefix_ids) - len(self.suffix_ids), 0)
        for row, text in enumerate(prompts):
            body = self.encode(text)
            if len(body) > room:
                body = body[:room] if self.truncation_side == "right" else body[len(body) - room:]
            toks = self.prefix_ids + body + self.suffix_ids
            toks = toks[:max_length]
            sl = (slice(0, len(toks)) if self.padding_side == "right"
                  else slice(max_length - len(toks), max_length))
            ids[row, sl] = toks
            mask[row, sl] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer_dir(path: str, what: str, pad_to_eos: bool = False):
    """The T5 or Llama tokenizer directory ``path`` as ``AutoTokenizer``
    reads it: ``tokenizer.json`` (with its config files) when present, else
    the CLIP BPE layout (``vocab.json`` + ``merges.txt``) of the
    repository's snapshots; ``spiece.model`` alone is refused by name. With
    ``pad_to_eos`` a tokenizer that names no pad token pads with eos, as
    diffusers' HiDreamImagePipeline does. (CLIP directories are read by
    ``edit.sd.load_tokenizer``: every CLIP snapshot ships ``vocab.json`` +
    ``merges.txt``, and CLIP's own ``tokenizer.json`` has an NFC normalizer
    that this reader does not take.)"""
    if os.path.exists(os.path.join(path, "tokenizer.json")):
        tok = HFTokenizer.from_pretrained(path)
        if pad_to_eos and tok.pad_token is None:
            tok.pad_token = tok.eos_token
        return tok
    if all(os.path.exists(os.path.join(path, f)) for f in ("vocab.json", "merges.txt")):
        return CLIPTokenizer.from_pretrained(path)
    if os.path.exists(os.path.join(path, "spiece.model")):
        raise NotImplementedError(
            f"{path} holds spiece.model but no tokenizer.json: the {what} tokenizer is "
            "read from tokenizer.json (SentencePiece's model file needs the "
            "sentencepiece package)")
    raise FileNotFoundError(f"{path} holds no tokenizer.json and no vocab.json + merges.txt "
                            f"for the {what} tokenizer")
