"""The benchmark's tokenizer files, written at run time where the program
reads them (a directory under the run's temporary directory).

CLIP: the published layout of 49,408 ids (the 256 byte-level characters,
the same with ``</w>``, then merge results, then ``<|startoftext|>`` 49406
and ``<|endoftext|>`` 49407) with no merges: the ids past 511 are unused
placeholders, every word is its characters, and a prompt of 77 tokens is
still 77 tokens.
"""

from __future__ import annotations

import json
import os

CLIP_IDS = 49408


def byte_chars() -> list[tuple[int, str]]:
    """(byte, GPT-2/CLIP's printable character for it), in CLIP's id order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [(b, chr(c)) for b, c in zip(bs, cs)]


def clip_vocab() -> dict[str, int]:
    chars = [c for _, c in byte_chars()]
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": 256 + i for i, c in enumerate(chars)})
    vocab.update({f"<|unused_{i}|>": i for i in range(512, CLIP_IDS - 2)})
    vocab["<|startoftext|>"] = CLIP_IDS - 2
    vocab["<|endoftext|>"] = CLIP_IDS - 1
    return vocab


def write_clip(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(clip_vocab(), f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}, f)
    return path

