"""The plain reference against the port, module by module, at tiny widths
on the CPU in float32 (the port's plain versions of its kernels), and the
reference tokenizers against the port's over the traffic corpora."""

import csv

import numpy as np
import pytest
import torch

from perfbench.core import harness, vocab
from perfbench.reference import generate as ref, sched, sd as rsd, text, uce
from perfbench.reference.tokenize import clip_ids
from perfbench.reference.weights import draw
from perfbench.tests import tiny


def _close(a, b, tol=1e-5):
    assert torch.allclose(a, b, atol=tol * b.abs().max().item(), rtol=0)


def test_unet_vae_clip_match_the_port():
    from uce_tpu_torch.models import clip_text, unet, vae

    cfg = tiny.config("sd14")
    w = ref.sd_weights(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(0)
    x, t = torch.randn(2, 4, 16, 16, generator=g), torch.tensor([999.0, 21.0])
    ctx = torch.randn(2, 77, 32, generator=g)
    _close(unet.apply(w["unet"], x, t, ctx, unet.UNetConfig.from_hf(cfg["unet"])),
           rsd.unet(w["unet"], cfg["unet"], x, t, ctx))
    _close(vae.decode(w["vae"], x, vae.VAEConfig.from_hf(cfg["vae"])),
           rsd.vae_decode(w["vae"], cfg["vae"], x))
    tcfg = clip_text.CLIPTextConfig.from_hf(cfg["text_encoder"])
    ids = torch.randint(0, 49408, (2, 77), generator=g)
    got = clip_text.encode_tokens(clip_text.convert_hf_state_dict(w["text"], tcfg), ids, tcfg)
    want = text.clip_encode(w["text"], cfg["text_encoder"], ids)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("name", ["pndm", "euler"])
def test_samplers_match_the_port(name):
    from uce_tpu_torch.diffusion import schedulers

    cfg = harness.read_json(harness.BENCH / "configs" / "sd14.json")["scheduler"]
    plan = schedulers.plan_from_hf_as(name, cfg, 20)
    x0 = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(2))

    def model(x, t):
        return torch.sin(3 * x + t / 300.0)

    lat = x0 * plan.init_noise_sigma
    carry = plan.init_carry(lat)
    for i in range(plan.num_calls):
        t = float(plan.timesteps[i])
        lat, carry = plan.step(model(plan.scale_model_input(lat, i), t), i, lat, carry)
    want = getattr(sched, name)(cfg, 20, model, x0)
    _close(lat, want, 1e-5)


def test_uce_edit_matches_a_float64_solve_and_the_port():
    from uce_tpu_torch.ops.solver import apply_edit_matrix, uce_edit_matrix

    g = torch.Generator().manual_seed(5)
    c_edit, c_guide, c_pres = (torch.randn(k, 64, generator=g) for k in (5, 5, 3))
    w = torch.randn(40, 64, generator=g)
    e = uce.edit_matrix(c_edit, c_guide, c_pres)
    lam = 0.5 * torch.eye(64, dtype=torch.float64)
    mat2 = lam + c_edit.double().T @ c_edit.double() + c_pres.double().T @ c_pres.double()
    mat_a = lam + c_guide.double().T @ c_edit.double() + c_pres.double().T @ c_pres.double()
    assert torch.allclose(e @ mat2, mat_a, atol=1e-9)
    got = apply_edit_matrix(w, uce_edit_matrix(c_edit, c_guide, c_pres))
    _close(got, uce.erase({"w": w}, c_edit, c_guide, c_pres)["w"], 1e-4)


def _corpus_prompts():
    out = []
    for name in ("big_artist_prompts.csv", "coco_2k.csv"):
        with open(harness.BENCH / "prompts" / name, newline="", encoding="utf-8") as f:
            out += [r["prompt"] for r in csv.DictReader(f)]
    return out + ["", "art", "  two  spaces ", "café über 漢字x"]


def test_tokenizers_match_the_port(tmp_path):
    from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer

    clip = CLIPTokenizer.from_pretrained(vocab.write_clip(str(tmp_path / "clip")))
    words = vocab.clip_vocab()
    assert len(words) == 49408
    for p in _corpus_prompts():
        enc = clip([p], padding="max_length", max_length=77, truncation=True)
        ids, mask = clip_ids(words, p, 77)
        assert list(enc["input_ids"][0]) == ids, p
        assert list(enc["attention_mask"][0]) == mask, p


def test_weights_are_seeded_and_scaled():
    shapes = {"a.weight": (64, 32), "a.bias": (64,), "n.weight": (64,),
              "token_embedding.weight": (100, 16)}
    one, two = draw(shapes, 7, "cpu", torch.float32), draw(shapes, 7, "cpu", torch.float32)
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one["a.weight"], draw(shapes, 8, "cpu", torch.float32)["a.weight"])
    assert abs(one["a.weight"].std().item() - 32 ** -0.5) < 0.02
    assert abs(one["token_embedding.weight"].std().item() - 1.0) < 0.1
    assert one["a.bias"].abs().sum() == 0 and torch.equal(one["n.weight"], torch.ones(64))
