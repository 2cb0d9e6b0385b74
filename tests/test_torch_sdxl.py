"""The port's SDXL path against uce_tpu on tests/test_sdxl_pipeline.py's tiny
snapshot: the text_time UNet forward (fp32, the bar of
tests/test_unet_cross_impl.py), the dual-encoder prompt and concept
encodings, images of a 3-step Euler run within 1 uint8 level, and
``edit-sdxl`` through the port's CLI against uce_tpu's ``run_erase`` (the
bar of tests/test_torch_edit_sd.py). The full-width configurations and
their parameter layouts are held to uce_tpu's too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sdxl_pipeline import make_sdxl_snapshot
from tests.test_torch_sdxl_sd21_shapes import _ShapeRng
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import clip_text as jct, unet as junet
from uce_tpu_torch.models import clip_text as tct, unet as tunet
from uce_tpu_torch.models.convert import nested_to_state_dict

EDITS = ["--edit_concepts", "cat; Van Gogh", "--concept_type", "art",
         "--preserve_concepts", "dog; a house", "--erase_scale", "3"]


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return make_sdxl_snapshot(tmp_path_factory.mktemp("torch_sdxl"))


@pytest.fixture(scope="module")
def pipes(snap):
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    return (JaxPipeline.from_pretrained(snap, dtype=jnp.float32),
            SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("name", ["SD21_UNET_CONFIG", "SDXL_UNET_CONFIG"])
def test_full_width_unet_configs_match_uce_tpu(name):
    """The published configurations, their HF round trip, and every
    parameter's name and shape (add_embedding included), without weights."""
    tcfg, jcfg = getattr(tunet, name), getattr(junet, name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tunet.UNetConfig.from_hf(tcfg.to_hf()) == tcfg
    got = {k: v.shape for k, v in tunet.init_state_dict(tcfg, _ShapeRng()).items()}
    want = {k: v.shape for k, v in junet.init_state_dict(jcfg, _ShapeRng()).items()}
    assert got == want


@pytest.mark.parametrize("name", ["SD2_TEXT_CONFIG", "SDXL_TEXT2_CONFIG"])
def test_full_width_text_configs_match_uce_tpu(name):
    tcfg, jcfg = getattr(tct, name), getattr(jct, name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tct.CLIPTextConfig.from_hf(tcfg.to_hf()) == tcfg


def test_vae_scaling_factor_from_config():
    """SDXL's VAE keeps SD's shapes and reads its scaling factor (0.13025)
    from its config, as uce_tpu does, and so does FLUX's shift_factor."""
    from uce_tpu.models import vae as jvae
    from uce_tpu_torch.models import vae as tvae

    hf = dict(tvae.SD_VAE_CONFIG.to_hf(), scaling_factor=0.13025)
    assert tvae.VAEConfig.from_hf(hf).scaling_factor == 0.13025
    assert tvae.VAEConfig.from_hf(hf) == dataclasses.replace(
        tvae.SD_VAE_CONFIG, scaling_factor=0.13025)
    assert jvae.VAEConfig.from_hf(hf).scaling_factor == 0.13025
    shifted = dict(hf, shift_factor=0.1159)
    assert tvae.VAEConfig.from_hf(shifted).shift_factor == \
        jvae.VAEConfig.from_hf(shifted).shift_factor == 0.1159


def test_text_time_unet_matches_uce_tpu(snap):
    """The snapshot's SDXL-shaped UNet (two levels, transformer depth 1 and
    2, linear projections, text_time added conditioning) on uce_tpu's
    weights carried across by models/convert.py."""
    import json

    hf = json.load(open(f"{snap}/unet/config.json"))
    jcfg, tcfg = junet.UNetConfig.from_hf(hf), tunet.UNetConfig.from_hf(hf)
    assert tcfg.addition_embed_type == "text_time"
    jparams = junet.nest_state_dict(
        junet.init_state_dict(jcfg, np.random.default_rng(3), scale=0.1))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 40)).astype(np.float32)
    text_embeds = rng.standard_normal((2, 16)).astype(np.float32)
    time_ids = np.array([[32, 32, 0, 0, 32, 32], [64, 48, 8, 4, 64, 48]], np.float32)
    t = np.array([123.0, 801.0], np.float32)
    want = np.asarray(jax.jit(lambda p, x, t, c, ac: junet.apply(p, x, t, c, jcfg,
                                                                 added_cond=ac))(
        jparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        {"text_embeds": jnp.asarray(text_embeds), "time_ids": jnp.asarray(time_ids)}))
    params = nested_to_state_dict(jparams)
    assert params["add_embedding.linear_1.weight"].shape == (
        tcfg.time_embed_dim, tcfg.projection_class_embeddings_input_dim)
    got = tunet.apply(params, torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(t), torch.from_numpy(ctx), tcfg,
                      added_cond={"text_embeds": torch.from_numpy(text_embeds),
                                  "time_ids": torch.from_numpy(time_ids)})
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="added_cond"):
        tunet.apply(params, torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(t), torch.from_numpy(ctx), tcfg)


def test_pipeline_loads_the_second_encoder(pipes):
    jpipe, pipe = pipes
    assert pipe.is_sdxl and jpipe.is_sdxl
    assert pipe.text_config_2.projection_dim == 16
    assert pipe.text_params_2["text_projection"].shape == (16, 16)
    assert pipe.tokenizer_2 is not None


def test_encode_prompts_sdxl_matches_uce_tpu(pipes):
    jpipe, pipe = pipes
    prompts = ["a cat riding a bicycle", "", "Van Gogh"]
    j_ctx, j_pooled = jpipe.encode_prompts_sdxl(prompts)
    t_ctx, t_pooled = pipe.encode_prompts_sdxl(prompts)
    assert tuple(t_ctx.shape) == (3, 16, 40) and tuple(t_pooled.shape) == (3, 16)
    tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(t_ctx.numpy(), np.asarray(j_ctx), **tol)
    np.testing.assert_allclose(t_pooled.numpy(), np.asarray(j_pooled), **tol)
    np.testing.assert_allclose(pipe.encode_prompts(prompts).numpy(),
                               np.asarray(jpipe.encode_prompts(prompts)), **tol)


def test_encode_concepts_sdxl_matches_uce_tpu(pipes):
    from uce_tpu.edit.embeddings import encode_concepts_sdxl as jencode
    from uce_tpu_torch.edit.embeddings import encode_concepts_sdxl

    jpipe, pipe = pipes
    concepts = ["cat", "Van Gogh", "a house", "cat"]
    want = jencode(jpipe.text_params, jpipe.text_config, jpipe.tokenizer,
                   jpipe.text_params_2, jpipe.text_config_2, jpipe.tokenizer_2,
                   concepts)
    got = encode_concepts_sdxl(pipe.text_params, pipe.text_config, pipe.tokenizer,
                               pipe.text_params_2, pipe.text_config_2,
                               pipe.tokenizer_2, concepts, device="cpu")
    assert list(got) == list(want) == ["cat", "Van Gogh", "a house"]
    for k in want:
        assert got[k].shape == (40,)
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-5, rtol=1e-4)
    short = dataclasses.replace(pipe.text_config_2, max_position_embeddings=8)
    with pytest.raises(ValueError, match="sequence length"):
        encode_concepts_sdxl(pipe.text_params, pipe.text_config, pipe.tokenizer,
                             pipe.text_params_2, short, pipe.tokenizer_2,
                             concepts, device="cpu")


@pytest.mark.parametrize("seed", [5, 11])
def test_euler_images_match_uce_tpu(pipes, seed):
    """3 Euler steps under CFG with a negative prompt (its pooled vector
    feeds the uncond branch's added conditioning)."""
    jpipe, pipe = pipes
    kw = dict(num_inference_steps=3, guidance_scale=7.5, seed=seed, height=32,
              width=32, scheduler="euler", negative_prompt="blurry")
    want = np.asarray(jpipe("a cat riding a bicycle", **kw))
    got = pipe("a cat riding a bicycle", **kw)
    assert got.shape == want.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"
    assert want.std() > 0


@pytest.mark.parametrize("method", ["collapsed", "general", "pallas"])
def test_edit_sdxl_cli_matches_uce_tpu(snap, tmp_path, method):
    """``edit-sdxl`` against uce_tpu's run_erase on the same snapshot; the
    pallas method at d=40 runs the Newton-Schulz plain version (a CPU
    tensor), held to uce_tpu's collapsed solve."""
    from safetensors.numpy import load_file

    from uce_tpu.edit import sd as jedit
    from uce_tpu.utils.prompts import resolve_edit_request

    from uce_tpu_torch.cli.main import main

    assert main(["edit-sdxl", "--model_id", snap, *EDITS, "--method", method,
                 "--save_dir", str(tmp_path), "--exp_name", "port",
                 "--device", "cpu"]) == 0
    ours = load_file(str(tmp_path / "port.safetensors"))
    edits, guides, preserves = resolve_edit_request(
        "cat; Van Gogh", None, "dog; a house", "art")
    want = jedit.run_erase(jedit.load_resources(snap, family="sdxl"), edits, guides,
                           preserves, erase_scale=3.0,
                           method="general" if method == "general" else "collapsed")
    assert list(ours) == sorted(want) and len(ours) == 16
    for k, v in want.items():
        assert ours[k].shape[-1] == 40
        np.testing.assert_allclose(ours[k], np.asarray(v), rtol=1e-3, atol=1e-5)


def test_sdxl_debias_loop_matches_uce_tpu(pipes, tmp_path):
    """tests/test_sdxl_pipeline.py::test_sdxl_debias_loop on both packages
    (fp32): run_debias takes its dual-encoder resources from the SDXL
    pipeline; every edited weight has the joined input width (24 + 16),
    and the port's weights and observed ratios equal uce_tpu's within the
    solver tolerance of tests/test_torch_debias.py."""
    from uce_tpu.edit.debias import DebiasSettings as JaxSettings, run_debias as jrun
    from uce_tpu_torch.edit.debias import DebiasSettings, run_debias

    class StubClip:
        def classify(self, images, labels):
            return np.arange(images.shape[0]) % len(labels)

    jpipe, pipe = pipes
    kw = dict(num_images_per_prompt=2, num_inference_steps=2, max_iterations=1)
    common = dict(save_dir=str(tmp_path), image_size=32, verbose=False)
    saved = jpipe.unet_params, pipe.unet_params
    try:
        jw, jacc, jhist = jrun(jpipe, StubClip(), ["doctor"], ["male", "female"],
                               settings=JaxSettings(**kw), exp_name="jxdl", **common)
        w, acc, hist = run_debias(pipe, StubClip(), ["doctor"], ["male", "female"],
                                  settings=DebiasSettings(**kw), exp_name="xdl", **common)
    finally:
        jpipe.unet_params, pipe.unet_params = saved
    assert list(w) == list(jw) and len(w) > 0
    for k, v in w.items():
        assert v.shape[-1] == 40, k
        np.testing.assert_allclose(v.numpy(), np.asarray(jw[k]), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(acc, jacc)
    assert len(hist) == len(jhist)
    for h, j in zip(hist, jhist):
        np.testing.assert_array_equal(h["observed"], j["observed"])
