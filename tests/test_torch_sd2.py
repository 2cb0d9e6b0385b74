"""The port's SD 2.x path against uce_tpu on tests/test_sd2_pipeline.py's tiny
snapshot (OpenCLIP-style gelu encoder, linear projections, per-block heads,
DDIM with v-prediction): images within 1 uint8 level with an edit overlay,
``edit-sd`` through the port's CLI against uce_tpu's ``run_erase``, and
``generate --scheduler ddim|lms|euler`` writing the case PNGs (the CLI
called in process)."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sd2_pipeline import make_sd2_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401

EDITS = ["--edit_concepts", "van gogh", "--concept_type", "art",
         "--preserve_concepts", "a house", "--erase_scale", "5"]


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    return make_sd2_snapshot(tmp_path_factory.mktemp("torch_sd2"))


@pytest.fixture(scope="module")
def edit_path(snap, tmp_path_factory):
    """``edit-sd`` through the port's CLI (in process)."""
    from uce_tpu_torch.cli.main import main

    out = tmp_path_factory.mktemp("torch_sd2_edit")
    assert main(["edit-sd", "--model_id", snap, *EDITS, "--save_dir", str(out),
                 "--exp_name", "vg", "--device", "cpu"]) == 0
    return str(out / "vg.safetensors")


def test_sd2_config_loaded(snap):
    from uce_tpu_torch.diffusion import schedulers
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    pipe = SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    assert not pipe.is_sdxl
    assert pipe.unet_config.use_linear_projection
    assert pipe.unet_config.attention_head_dim == (2, 4)
    assert pipe.text_config.hidden_act == "gelu"
    plan = schedulers.plan_from_hf(pipe.scheduler_config, 5)
    assert (plan.kind, plan.prediction_type) == ("ddim", "v_prediction")
    euler = schedulers.plan_from_hf_as("euler", pipe.scheduler_config, 5)
    assert (euler.kind, euler.prediction_type) == ("euler", "v_prediction")


@pytest.fixture(scope="module")
def pipes(snap, edit_path):
    """uce_tpu's and the port's pipelines, both with the edit overlay."""
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    jpipe = JaxPipeline.from_pretrained(snap, dtype=jnp.float32)
    jpipe.load_uce_edits(edit_path)
    pipe = SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    before = dict(pipe.unet_params)
    pipe.load_uce_edits(edit_path)
    # the overlay replaced every cross-attention K/V weight
    edited = [k for k in before if not torch.equal(before[k], pipe.unet_params[k])]
    assert len(edited) == 8 and all(".attn2.to_" in k for k in edited)
    return jpipe, pipe


@pytest.mark.parametrize("seed", [5, 11])
def test_ddim_v_prediction_images_match_uce_tpu(pipes, seed):
    jpipe, pipe = pipes
    kw = dict(num_inference_steps=3, guidance_scale=7.5, seed=seed, height=32,
              width=32)
    want = np.asarray(jpipe("van gogh field", **kw))
    got = pipe("van gogh field", **kw)
    assert got.shape == want.shape == (1, 32, 32, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"max uint8 diff {diff.max()}"


def test_edit_sd_cli_matches_uce_tpu(snap, edit_path):
    from safetensors.numpy import load_file

    from uce_tpu.edit import sd as jedit
    from uce_tpu.utils.prompts import resolve_edit_request

    ours = load_file(edit_path)
    edits, guides, preserves = resolve_edit_request("van gogh", None, "a house", "art")
    want = jedit.run_erase(jedit.load_resources(snap), edits, guides, preserves,
                           erase_scale=5.0)
    assert list(ours) == sorted(want) and len(ours) == 8
    for k, v in want.items():
        np.testing.assert_allclose(ours[k], np.asarray(v), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("scheduler", ["ddim", "lms", "euler"])
def test_generate_cli_schedulers_write_case_pngs(snap, edit_path, tmp_path, scheduler):
    from uce_tpu_torch.cli.main import main
    from uce_tpu_torch.utils.imaging import decode_png

    csv_path = tmp_path / "prompts.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "van gogh field", 1], [4, "a house", 2]])
    assert main(["generate", "--model_id", snap, "--prompts_path", str(csv_path),
                 "--save_path", str(tmp_path / "out"), "--uce_model_path", edit_path,
                 "--image_size", "32", "--num_inference_steps", "3",
                 "--scheduler", scheduler, "--device", "cpu"]) == 0
    folder = tmp_path / "out" / "vg"
    assert sorted(p.name for p in folder.iterdir()) == ["0_0.png", "4_0.png"]
    for name in ("0_0.png", "4_0.png"):
        img = decode_png((folder / name).read_bytes())
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8 and img.std() > 0
