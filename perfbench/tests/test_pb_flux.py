"""The FLUX.1 family: the plain reference against the port, module by
module, at tiny widths on the CPU in float32 (the port's plain versions of
its kernels); the benchmark's T5 tokenizer against the port's
``tokenizer.json`` reader over the corpora; whole tiny runs of the cell,
sound and with the timed path broken; the work of one image at the
published widths; and the cell's span readers.

Tolerances: where the port and the reference compute the same float32
math in another order, 1e-5 of the largest magnitude (float32 rounding,
about 1e-7 an operation, over tens of chained operations); the erase,
which the port solves in float32 and the reference in float64, 1e-4 (the
system's conditioning at these sizes times float32's 1e-7); a sound run's
images, 0.3 levels (the port rounds to uint8, a quarter level on average).
"""

import copy
import csv
import time

import numpy as np
import pytest
import torch

from perfbench.core import harness, vocab, vocab_t5, work
from perfbench.reference import flux as rflux, generate_flux as ref, t5 as rt5
from perfbench.reference.sd import vae_decode
from perfbench.tests import tiny

CELL = "flux-schnell-eval-b2"
T5 = {"d_model": 24, "d_kv": 6, "num_heads": 4, "d_ff": 48, "num_layers": 2,
      "vocab_size": 32128, "relative_attention_num_buckets": 32,
      "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
      "is_gated_act": True, "dense_act_fn": "gelu_new", "feed_forward_proj": "gated-gelu"}
DIT = {"in_channels": 16, "num_layers": 1, "num_single_layers": 1, "attention_head_dim": 16,
       "num_attention_heads": 2, "joint_attention_dim": 24, "pooled_projection_dim": 32,
       "guidance_embeds": False, "axes_dims_rope": [4, 6, 6]}
VAE = dict(tiny.VAE, scaling_factor=0.3611, shift_factor=0.1159, use_post_quant_conv=False)
TRAFFIC = dict(size=32, steps=2)


def _close(a, b, tol=1e-5):
    assert torch.allclose(a, b, atol=tol * b.abs().max().item(), rtol=0)


def config() -> dict:
    """flux1-schnell at tiny widths, float32, with a shorter T5 sequence."""
    cfg = copy.deepcopy(harness.read_json(harness.BENCH / "configs" / "flux1-schnell.json"))
    cfg.update(dtype="float32", max_sequence_length=64, edit=dict(tiny.EDIT),
               transformer=dict(DIT), text_encoder_2=dict(T5), text_encoder=dict(tiny.CLIP),
               vae=dict(VAE))
    return cfg


def cell_files() -> dict:
    """The cell's files with the tiny configuration and traffic."""
    files = harness.cell_files(harness.read_json(harness.ROOT / "BENCHMARK.json"), CELL)
    files["config"] = config()
    files["traffic"] = dict(files["traffic"], **TRAFFIC)
    return files


def run(tmp_path, seed=5, trace=False, control=False, seconds=0.1):
    return harness.run_cell(cell_files(), seed, seconds, trace, torch.device("cpu"),
                            str(tmp_path), time.perf_counter(), control=control)


def test_t5_matches_the_port():
    from uce_tpu_torch.models import t5

    cfg = config()
    w = ref.flux_weights(cfg, 3, "cpu", ("t5",))["t5"]
    tcfg = t5.T5Config.from_hf(cfg["text_encoder_2"])
    ids = torch.randint(0, 32100, (2, 64), generator=torch.Generator().manual_seed(0))
    got = t5.encode_tokens(t5.convert_hf_state_dict(w, tcfg), ids, None, tcfg)
    _close(got, rt5.t5_encode(w, cfg["text_encoder_2"], ids))


def test_dit_matches_the_port():
    from uce_tpu_torch.diffusion.pipeline_flux import make_img_ids
    from uce_tpu_torch.models import flux

    cfg = config()
    w = ref.flux_weights(cfg, 3, "cpu", ("dit",))["dit"]
    g = torch.Generator().manual_seed(1)
    x, ctx = torch.randn(2, 64, 16, generator=g), torch.randn(2, 64, 24, generator=g)
    pooled, t = torch.randn(2, 32, generator=g), torch.tensor([1.0, 0.25])
    got = flux.apply(w, x, ctx, pooled, t, make_img_ids(16, 16), np.zeros((64, 3)),
                     flux.FluxConfig.from_hf(cfg["transformer"]))
    _close(got, rflux.dit(w, cfg["transformer"], x, ctx, pooled, t, 16, 16))


def test_packing_matches_the_port():
    from uce_tpu_torch.diffusion import pipeline_flux

    z = torch.randn(2, 4, 8, 6, generator=torch.Generator().manual_seed(2))
    assert torch.equal(rflux.pack(z), pipeline_flux.pack_latents(z))
    assert torch.equal(rflux.unpack(rflux.pack(z), 8, 6), z)
    assert np.array_equal(rflux.image_ids(8, 6).numpy(), pipeline_flux.make_img_ids(8, 6))


@pytest.mark.parametrize("steps", [1, 4, 7])
def test_sampler_matches_the_port(steps):
    from uce_tpu_torch.diffusion import schedulers

    cfg = config()["scheduler"]
    plan = schedulers.flow_match_euler_plan(steps, shift=cfg["shift"])
    x0 = torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(3))

    def model(x, t):
        return torch.sin(3 * x + 2 * t)

    lat = x0
    for i in range(plan.num_calls):
        t = float(np.float32(plan.timesteps[i]) / np.float32(1000.0))
        lat = plan.step(model(lat, t), i, lat, [])[0]
    _close(lat, rflux.flow_match_euler(cfg, steps, model, x0), 1e-6)
    assert rflux.sigmas(cfg, 4).tolist() == [1.0, 0.75, 0.5, 0.25, 0.0]


def test_vae_without_post_quant_conv_matches_the_port():
    """The port decodes FLUX.1's VAE, which has no post_quant_conv; the
    reference decodes through an identity one, which changes nothing."""
    from uce_tpu_torch.models import vae

    cfg = config()
    w = ref.flux_weights(cfg, 3, "cpu", ("vae",))["vae"]
    assert not any(k.startswith("post_quant_conv") for k in w)
    z = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(4))
    got = vae.decode(w, z, vae.VAEConfig.from_hf(cfg["vae"]))
    _close(got, vae_decode(ref.with_identity_post_quant_conv(w, cfg["vae"]), cfg["vae"], z))


def _prompts():
    out = []
    for name in ("big_artist_prompts.csv", "coco_2k.csv"):
        with open(harness.BENCH / "prompts" / name, newline="", encoding="utf-8") as f:
            out += [r["prompt"] for r in csv.DictReader(f)]
    return out + ["", " ", "art", "  two  spaces ", "café über 漢字x", "a\n\nb",
                  "</s>x<extra_id_3>", "<unk>漢", "x" * 300]


def test_t5_tokenizer_matches_the_port(tmp_path):
    from uce_tpu_torch.models.hf_tokenizer import load_tokenizer_dir

    port = load_tokenizer_dir(vocab_t5.write_t5(str(tmp_path / "t5")), "T5")
    words = vocab_t5.t5_vocab()
    assert len(words) == 32100 and words["<pad>"] == 0 and words["</s>"] == 1
    assert words["<unk>"] == 2 and words["<extra_id_0>"] == 32099
    assert words["<extra_id_99>"] == 32000
    for p in _prompts():
        enc = port([p], padding="max_length", max_length=256, truncation=True)
        ids, mask = rt5.t5_ids(words, p, 256)
        assert list(enc["input_ids"][0]) == ids, p
        assert list(enc["attention_mask"][0]) == mask, p


def test_erase_matches_a_float64_solve(tmp_path):
    """The port's FLUX erase (``edit/flux.py``, float32 on the device) against
    the reference's (float64, from its own embeddings of each stream)."""
    from uce_tpu_torch.edit import flux as edit_flux
    from uce_tpu_torch.models import clip_text, t5
    from uce_tpu_torch.models.clip_tokenizer import CLIPTokenizer
    from uce_tpu_torch.models.hf_tokenizer import load_tokenizer_dir

    cfg = config()
    w = ref.flux_weights(cfg, 7, "cpu")
    ccfg = clip_text.CLIPTextConfig.from_hf(cfg["text_encoder"])
    tcfg = t5.T5Config.from_hf(cfg["text_encoder_2"])
    targets = {k: w["dit"][k] for k in (ref.T5_TARGET, ref.CLIP_TARGET)}
    res = edit_flux.FluxEditResources(
        targets=targets, t5_params=t5.convert_hf_state_dict(w["t5"], tcfg), t5_config=tcfg,
        t5_tokenizer=load_tokenizer_dir(vocab_t5.write_t5(str(tmp_path / "t5")), "T5"),
        clip_params=clip_text.convert_hf_state_dict(w["clip"], ccfg), clip_config=ccfg,
        clip_tokenizer=CLIPTokenizer.from_pretrained(vocab.write_clip(str(tmp_path / "c"))),
        max_sequence_length=64, device=torch.device("cpu"))
    edit = cfg["edit"]
    got = edit_flux.run_erase(res, edit["erase"], edit["guide"], edit["preserve"],
                              lamb=edit["lamb"])
    concepts = edit["erase"] + edit["guide"] + edit["preserve"]
    hidden, masks, pooled = ref.encode(cfg, w["t5"], w["clip"], concepts, "cpu")
    last = hidden[torch.arange(len(masks)), torch.as_tensor([sum(m) - 2 for m in masks])]
    want = ref.erase(w["dit"], edit, last, pooled)
    for k in targets:
        _close(got[k], want[k], 1e-4)
        assert not torch.allclose(want[k], targets[k], atol=1e-3)  # the erase moved it


def test_a_sound_run_is_correct(tmp_path):
    out = run(tmp_path, trace=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["image_gap_worst"]["value"] < 0.3
    assert out["attempted"] >= 2 and out["failed"] == 0


def _unchanged_step(monkeypatch):
    from uce_tpu_torch.diffusion import schedulers
    monkeypatch.setattr(schedulers.Plan, "step", lambda self, v, i, x, carry: (x, carry))


def _patch_images(monkeypatch, change):
    """Change the uint8 images where the FLUX pipeline produces them."""
    from uce_tpu_torch.diffusion import pipeline_flux

    made = pipeline_flux.decoded_images
    monkeypatch.setattr(pipeline_flux, "decoded_images",
                        lambda *args, **kwargs: change(made(*args, **kwargs)))


def _half_batch(monkeypatch):
    def half(images):
        n = (len(images) + 1) // 2
        return np.concatenate([images[:n], images[:len(images) - n]])
    _patch_images(monkeypatch, half)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": lambda mp: _patch_images(
              mp, lambda im: np.clip(im.astype(np.int16) + 40, 0, 255).astype(np.uint8)),
          "mixed_up_answers": lambda mp: _patch_images(mp, lambda im: np.roll(im, 1, axis=0))}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(fault, tmp_path, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(tmp_path)
    assert not out["correct"], out["checks"]


def test_the_dit_draw_spreads_input_channels():
    """Each 2-D DiT weight is the flat draw with its input channels scaled
    by one factor each, of root mean square 1 and unlike one another; the
    same seed gives the same weights; the other parts are left flat."""
    cfg = config()
    w = ref.flux_weights(cfg, 3, "cpu", ("dit", "vae"))
    flat = ref.flux_weights(dict(cfg, dit_channel_log_std=0.0), 3, "cpu", ("dit", "vae"))
    for k, v in w["dit"].items():
        if v.ndim != 2:
            assert torch.equal(v, flat["dit"][k])
            continue
        scale = v[0] / flat["dit"][k][0]
        assert torch.allclose(v, flat["dit"][k] * scale, rtol=1e-6)
        assert scale.square().mean().sqrt() == pytest.approx(1.0, rel=1e-5)
        assert scale.max() > 1.5 * scale.min()
    assert all(torch.equal(v, flat["vae"][k]) for k, v in w["vae"].items())
    again = ref.flux_weights(cfg, 3, "cpu", ("dit",))["dit"]
    assert all(torch.equal(v, again[k]) for k, v in w["dit"].items())


def test_the_control_reads_far_from_the_reference(tmp_path):
    """The DiT's W8A8 path moves the images past the sound run's rounding.
    At these widths int8's steps are finer than at FLUX.1's (absmax over 16
    to 64 channels, not 3,072), so it reads 2-2.5x the float32 run here; the
    limit is set on the card, at the published widths, against the bf16
    program."""
    sound = run(tmp_path)["checks"]["image_gap_worst"]["value"]
    gap = run(tmp_path, control=True)["checks"]["image_gap_worst"]["value"]
    assert gap > 0.45 and gap > 2 * sound


def test_the_parent_program_fails_at_once(tmp_path, monkeypatch):
    """A program whose VAE always applies post_quant_conv (the VAEConfig of
    the port before FLUX.1's VAE) is refused before any weight is drawn."""
    import dataclasses

    from uce_tpu_torch.models import vae

    @dataclasses.dataclass(frozen=True)
    class Old:
        latent_channels: int = 4

    monkeypatch.setattr(vae, "VAEConfig", Old)
    monkeypatch.setattr(ref, "flux_weights", lambda *a, **k: pytest.fail("weights drawn"))
    with pytest.raises(SystemExit, match="post_quant_conv"):
        run(tmp_path)


def _published():
    return (harness.read_json(harness.BENCH / "configs" / "flux1-schnell.json"),
            harness.read_json(harness.BENCH / "traffic" / "eval-coco-flux-b2.json"))


def test_flux_flops():
    """A DiT forward at 1024^2 (4,096 image and 256 text positions) counted
    against its matrix products: 12 d^2 multiply-adds a position a block
    (double: q, k, v, out, MLP 4d in and out per stream; single: q, k, v,
    MLP in 4d, out of 5d), the modulations once a sample, the joint
    attention's 2 S^2 d a block, and the embedders and the head."""
    cfg, traffic = _published()
    items = ref.flux_work(cfg, traffic)
    assert {label: times for label, _, times in items} == {"dit": 4, "vae": 1, "t5": 1, "clip": 1}
    d, s_img, s_txt = 3072, 4096, 256
    s = s_img + s_txt
    macs = (19 * (12 * d * d * s + 12 * d * d + 2 * s * s * d)
            + 38 * (12 * d * d * s + 3 * d * d + 2 * s * s * d)
            + s_img * 64 * d + s_txt * 4096 * d + (256 + 768) * d + 2 * d * d
            + 2 * d * d + s_img * d * 64)
    one = {label: work.flops_per_image([(label, fn, 1)]) for label, fn, _ in items}
    assert one["dit"] == 2 * macs
    assert one["dit"] / 1e12 == pytest.approx(69.5, abs=0.1)
    assert work.flops_per_image(items) / 1e12 == pytest.approx(4 * 69.5 + 10.1 + 2.5, abs=0.5)


def test_attention_calls_of_a_flux_image():
    cfg, traffic = _published()
    calls = work.attention_calls(ref.flux_work(cfg, traffic))
    assert sorted(set(calls)) == [((1, 1, 16384, 16384, 512), 1),
                                  ((1, 24, 4352, 4352, 128), 4)]
    assert sum(1 for c, _ in calls if c[4] == 128) == 57


class Spans:
    """A span list in the program's form."""

    def __init__(self):
        self.out, self.next = [], 1

    def add(self, name, t, stream_s, parent=None, profiled=False, **attrs):
        self.out.append({"name": name, "id": self.next, "parent": parent,
                         "start_ns": int(t * 1e9), "end_ns": int((t + 0.1) * 1e9),
                         "host_s": 0.1, "stream_s": stream_s, "profiled": profiled, **attrs})
        self.next += 1
        return self.next - 1


def flux_calls(n_calls, attn=57):
    """A warm-up call and a profiled one, then the rest: call c's DiT
    forwards read 400 + c ms, its encode 50 + c, its decode 70 + c."""
    sp = Spans()
    for c in range(n_calls):
        prof, slow = c == 1, 1000.0 if c < 2 else 1.0
        call = sp.add("pipe.call", c, 2.0, profiled=prof, batch=2, steps=4)
        sp.add("pipe.encode", c, slow * (0.050 + c / 1e3), call, prof)
        for i in range(4):
            sp.add("pipe.model", c, slow * (0.400 + c / 1e3), call, prof, call=i,
                   conv3x3=0, group_norm_act=0, sd_attention=attn)
            sp.add("pipe.step", c, 0.0001, call, prof, call=i)
        sp.add("pipe.decode", c, slow * (0.070 + c / 1e3), call, prof)
    return sp.out


@pytest.mark.parametrize("name,per_call", [("dit_ms.flux", 400), ("encode_ms.flux", 50),
                                           ("decode_ms.flux", 70)])
def test_span_readers(name, per_call):
    read = harness.load("metrics", name).value
    assert read(flux_calls(14)) == pytest.approx(per_call + 7.5)  # calls 2..13
    assert read(flux_calls(7)) == pytest.approx(per_call + 4.0)  # 5 calls: 20 forwards
    few = read(flux_calls(6))  # 4 calls: 16 forwards, but 4 encodes and decodes
    assert (few is None) if name != "dit_ms.flux" else few == pytest.approx(per_call + 3.5)
    assert read([]) is None


def test_attention_launches_reader():
    read = harness.load("metrics", "attn_kernels_per_call.flux").value
    assert read(flux_calls(6)) == 57
    assert read(flux_calls(6, attn=38)) == 38
    assert read(flux_calls(4)) is None  # 8 measured forwards
    bare = [{k: v for k, v in s.items() if k != "sd_attention"} for s in flux_calls(6)]
    assert read(bare) is None


def test_read_without_the_recorder(monkeypatch):
    from uce_tpu_torch.utils import observability

    monkeypatch.delattr(observability, "spans")
    for name in ("dit_ms.flux", "encode_ms.flux", "decode_ms.flux",
                 "attn_kernels_per_call.flux"):
        assert harness.load("metrics", name).read({}) is None
