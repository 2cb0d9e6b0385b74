"""Plain float32 T5 v1.1 encoder (FLUX.1's ``text_encoder_2``, T5-v1.1-XXL)
over Hugging Face ``T5EncoderModel`` state dict names, and the tokenizer of
the benchmark's T5 vocabulary (``core/vocab_t5.py``).

As published (Raffel et al. 2020, and the v1.1 checkpoints): RMSNorm (no
mean, no bias), attention logits not scaled by 1/sqrt(d_kv), one bucketed
relative position bias (bidirectional, computed by the first layer's table
and added in every layer), a gated tanh-GELU feed-forward (``wi_0``,
``wi_1``, ``wo``) and a final RMSNorm. No attention mask: the pad tokens
attend, as diffusers' FluxPipeline runs the encoder.
"""

from __future__ import annotations

import math
import re

import torch
import torch.nn.functional as F

from perfbench.core import vocab_t5

REL_BIAS = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def _w(p, name):
    return p[name].float()


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def relative_buckets(q_len: int, k_len: int, num_buckets: int, max_distance: int):
    """[q_len, k_len] bucket of each (query, key) offset, bidirectional."""
    rel = torch.arange(k_len)[None, :] - torch.arange(q_len)[:, None]
    half = num_buckets // 2
    out = (rel > 0).long() * half
    n = rel.abs()
    exact = half // 2
    large = exact + (torch.log(n.clamp(min=1).float() / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    return out + torch.where(n < exact, n, large.clamp(max=half - 1))


def t5_encode(p, cfg, ids):
    """ids [B, T] -> last hidden state [B, T, d_model]."""
    b, t = ids.shape
    h, dk, eps = cfg["num_heads"], cfg["d_kv"], cfg["layer_norm_epsilon"]
    table = _w(p, REL_BIAS)
    buckets = relative_buckets(t, t, cfg["relative_attention_num_buckets"],
                               cfg["relative_attention_max_distance"]).to(table.device)
    bias = table[buckets].permute(2, 0, 1)[None]
    x = _w(p, "shared.weight")[ids]
    split = lambda z: z.reshape(b, t, h, dk).transpose(1, 2)
    for i in range(cfg["num_layers"]):
        L = f"encoder.block.{i}.layer."
        y = _rms(x, _w(p, L + "0.layer_norm.weight"), eps)
        q, k, v = (split(F.linear(y, _w(p, f"{L}0.SelfAttention.{n}.weight"))) for n in "qkv")
        probs = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        x = x + F.linear((probs @ v).transpose(1, 2).reshape(b, t, h * dk),
                         _w(p, L + "0.SelfAttention.o.weight"))
        y = _rms(x, _w(p, L + "1.layer_norm.weight"), eps)
        ff = L + "1.DenseReluDense."
        gate = F.gelu(F.linear(y, _w(p, ff + "wi_0.weight")), approximate="tanh")
        x = x + F.linear(gate * F.linear(y, _w(p, ff + "wi_1.weight")), _w(p, ff + "wo.weight"))
    return _rms(x, _w(p, "encoder.final_layer_norm.weight"), eps)


def t5_shapes(cfg) -> dict[str, tuple]:
    d, ff, inner = cfg["d_model"], cfg["d_ff"], cfg["num_heads"] * cfg["d_kv"]
    s = {"shared.weight": (cfg["vocab_size"], d),
         REL_BIAS: (cfg["relative_attention_num_buckets"], cfg["num_heads"])}
    for i in range(cfg["num_layers"]):
        L = f"encoder.block.{i}.layer."
        s[L + "0.layer_norm.weight"] = (d,)
        for n in "qkv":
            s[f"{L}0.SelfAttention.{n}.weight"] = (inner, d)
        s[L + "0.SelfAttention.o.weight"] = (d, inner)
        s[L + "1.layer_norm.weight"] = (d,)
        s[L + "1.DenseReluDense.wi_0.weight"] = (ff, d)
        s[L + "1.DenseReluDense.wi_1.weight"] = (ff, d)
        s[L + "1.DenseReluDense.wo.weight"] = (d, ff)
    s["encoder.final_layer_norm.weight"] = (d,)
    return s


_ADDED = re.compile("|".join(re.escape(t) for t in sorted(
    list(vocab_t5.SPECIALS) + [t for _, t in vocab_t5.sentinels()], key=len, reverse=True)))


def t5_ids(vocab: dict, text: str, length: int):
    """(ids, mask), each a list of ``length`` ints, as the benchmark's T5
    tokenizer gives them: special tokens in the text taken whole; elsewhere
    runs of spaces folded, a ``▁`` before the text and for each space, each
    character its piece or ``<unk>`` (a run of unknown characters one
    ``<unk>``); at most length - 1 tokens, then ``</s>``; ``<pad>`` pads."""
    unk, toks, at = vocab["<unk>"], [], 0
    parts = []
    for m in _ADDED.finditer(text):
        parts += [text[at:m.start()], m.group()]
        at = m.end()
    parts.append(text[at:])
    for i, part in enumerate(parts):
        if i % 2:
            toks.append(vocab[part])
            continue
        part = re.sub(" {2,}", " ", part).replace(" ", vocab_t5.SPACE)
        if not part:
            continue
        if not part.startswith(vocab_t5.SPACE):
            part = vocab_t5.SPACE + part
        known = True
        for ch in part:
            if ch in vocab:
                toks.append(vocab[ch])
            elif known:
                toks.append(unk)
            known = ch in vocab
    toks = toks[:length - 1] + [vocab["</s>"]]
    pad = length - len(toks)
    return toks + [vocab["<pad>"]] * pad, [1] * len(toks) + [0] * pad
