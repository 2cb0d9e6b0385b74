"""The port's CLIP vision tower and dual-tower CLIPModel
(uce_tpu_torch/models/clip.py) against uce_tpu.models.clip on the tiny
composite snapshot of tests/snapshot.py::make_clip_snapshot, fp32 (the
tolerances of tests/test_clip_vision.py), and the image preprocessing
within 2e-5 of uce_tpu's at down-sampled, up-sampled and non-square
sizes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.snapshot import make_clip_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import clip as jclip
from uce_tpu_torch.models import clip as tclip


@pytest.fixture(scope="module")
def clip_snap(tmp_path_factory):
    return make_clip_snapshot(tmp_path_factory.mktemp("torch_clip_vision"))


@pytest.fixture(scope="module")
def models(clip_snap):
    return (jclip.CLIPModel.from_pretrained(clip_snap),
            tclip.CLIPModel.from_pretrained(clip_snap, device="cpu"))


def _images(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


def test_configs_match_uce_tpu(models):
    jm, tm = models
    assert dataclasses.asdict(tm.vision_config) == dataclasses.asdict(jm.vision_config)
    assert dataclasses.asdict(tm.text_config) == dataclasses.asdict(jm.text_config)
    assert tm.logit_scale == pytest.approx(jm.logit_scale, rel=1e-7)
    assert tclip.CLIPVisionConfig() == tclip.CLIPVisionConfig.from_hf({})


def test_vision_tower_matches_uce_tpu(models):
    jm, tm = models
    rng = np.random.default_rng(3)
    pixels = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(jm.vision_params, jnp.asarray(pixels),
                                         jm.vision_config))
    got = tclip.encode_image(tm.vision_params,
                             torch.from_numpy(pixels.transpose(0, 3, 1, 2).copy()),
                             tm.vision_config)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("hw", [(32, 32), (64, 64), (48, 80)])
def test_logits_and_classify_match_uce_tpu(models, hw):
    jm, tm = models
    images = _images(4, *hw, seed=hw[1])
    labels = ["a man", "a woman", "a cat riding a bicycle"]
    want = jm.logits_per_image(images, labels)
    got = tm.logits_per_image(images, labels)
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(tm.classify(images, labels),
                                  np.asarray(jm.classify(images, labels)))


@pytest.mark.parametrize("hw,size", [((512, 512), 224), ((768, 768), 224),
                                     ((1024, 1024), 224), ((64, 64), 224),
                                     ((300, 500), 224), ((500, 300), 224),
                                     ((40, 90), 32), ((32, 32), 32)])
def test_preprocess_matches_uce_tpu(hw, size):
    """Bicubic with antialiasing on the shrink, as jax.image.resize; square
    down-sampled, up-sampled, non-square (either orientation) and
    unresized inputs: the resized pixels (0..1, before the normalization
    divides by CLIP's std ~0.27) within 2e-5."""
    images = _images(2, *hw, seed=sum(hw))
    mean, std = np.float32(tclip.CLIP_IMAGE_MEAN), np.float32(tclip.CLIP_IMAGE_STD)
    want = np.asarray(jclip.preprocess_images(images, size)) * std + mean
    got = tclip.preprocess_images(images, size, device="cpu")
    assert tuple(got.shape) == (2, 3, size, size)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1) * std + mean, want,
                               rtol=0, atol=2e-5)


def test_embed_texts_memoized(models, monkeypatch):
    _, tm = models
    calls = {"n": 0}
    real = tclip.clip_text.encode_tokens

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tclip.clip_text, "encode_tokens", counted)
    tm._text_cache.clear()
    a = tm.embed_texts(["a man", "a woman"])
    b = tm.embed_texts(["a man", "a woman"])
    assert calls["n"] == 1 and torch.equal(a, b)
    tm.embed_texts(["other"])
    assert calls["n"] == 2


def test_init_state_dict_loads(tmp_path):
    """The random full-tower state dict (chip_smoke's) has every key the
    converter reads, at ViT-B/32's shapes when asked."""
    cfg = tclip.CLIPVisionConfig(hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=2, intermediate_size=32,
                                 image_size=64, patch_size=32, projection_dim=8)
    sd = {k: torch.from_numpy(v) for k, v in
          tclip.init_state_dict(cfg, np.random.default_rng(0)).items()}
    params = tclip.convert_hf_vision_state_dict(sd, cfg)
    out = tclip.encode_image(params, torch.zeros(2, 3, 64, 64), cfg)
    assert tuple(out.shape) == (2, 8)
    assert tuple(params["position_embedding"].shape) == (5, 16)
