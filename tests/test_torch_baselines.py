"""The baseline CLIs of the port (``sld-generate``, ``concept-algebra``,
``debias-vl``; uce_tpu_torch/eval/baselines.py) against uce_tpu's
generators on a two-row prompts CSV and the tiny SD snapshot: the same
folders and PNG names, images within 1 uint8 level. And the kernels' calls
at the baselines' UNet batches (3n for SLD, 5n for concept algebra) and
decode batches, enumerated on meta tensors at SD 1.4's widths: the launches
chip_smoke.py expects."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.snapshot import make_sd_snapshot
from tests.test_torch_sdxl_sd21_shapes import SMS, _calls, _kernel_attention
from uce_tpu_torch.cli.main import main as cli_main
from uce_tpu_torch.eval import baselines
from uce_tpu_torch.ops.kernels import conv3x3 as port_conv
from uce_tpu_torch.ops.kernels import group_norm as port_gn
from uce_tpu_torch.utils.imaging import load_image

COMMON = ["--image_size", "32", "--dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    from uce_tpu.diffusion.pipeline import SDPipeline as JaxPipeline

    root = tmp_path_factory.mktemp("torch_baselines")
    snap = str(make_sd_snapshot(root / "diffusers-tiny"))
    prompts = root / "prompts.csv"
    with open(prompts, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["case_number", "prompt", "evaluation_seed"])
        w.writerows([[0, "a doctor", 11], [4, "a cat riding a bicycle", 12]])
    return snap, str(prompts), JaxPipeline.from_pretrained(snap, dtype=jnp.float32)


def _same_folders(got_root, want_root, folder, names):
    got_dir, want_dir = os.path.join(got_root, folder), os.path.join(want_root, folder)
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == names
    for name in names:
        got, want = (load_image(os.path.join(d, name)) for d in (got_dir, want_dir))
        assert got.shape == want.shape == (32, 32, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_sld_generate_matches_uce_tpu(rig, tmp_path):
    from uce_tpu.eval import baselines as jb

    snap, prompts, jpipe = rig
    jb.generate_sld(jpipe, prompts, str(tmp_path / "want"), sld_concept="violence",
                    sld_type="Max", ddim_steps=3, image_size=32, cases=[4, 7])
    assert cli_main(["sld-generate", "--model_name", snap, "--prompts_path", prompts,
                     "--save_path", str(tmp_path / "got"), "--sld_concept", "violence",
                     "--sld_type", "Max", "--ddim_steps", "3", "--cases", "4", "7",
                     *COMMON]) == 0
    _same_folders(tmp_path / "got", tmp_path / "want", "SLD_Max_violence", ["4_0.png"])


def test_concept_algebra_matches_uce_tpu(rig, tmp_path, capsys):
    from uce_tpu.eval import baselines as jb

    snap, prompts, jpipe = rig
    concepts = ["a man", "a woman", "a person"]
    jb.generate_concept_algebra(jpipe, prompts, concepts, str(tmp_path / "want"),
                                model_name="diffusers-tiny", ddim_steps=3, image_size=32,
                                num_samples=2)
    assert cli_main(["concept-algebra", "--model_name", snap + "/", "--prompts_path",
                     prompts, "--save_path", str(tmp_path / "got"), "--ddim_steps", "3",
                     "--num_samples", "2", *COMMON]) == 0
    assert "generated 2 cases" in capsys.readouterr().out
    _same_folders(tmp_path / "got", tmp_path / "want", "tiny",
                  ["0_0.png", "0_1.png", "4_0.png", "4_1.png"])
    with pytest.raises(SystemExit, match="Must provide 3 comma-separated concepts"):
        cli_main(["concept-algebra", "--model_name", snap, "--prompts_path", prompts,
                  "--save_path", str(tmp_path), "--concepts_to_project", "a man,a woman",
                  *COMMON])


def test_debias_vl_matches_uce_tpu(rig, tmp_path, capsys):
    """The default 80 professions when --debias_concepts is empty; the
    projection from the pipeline's own encoder, equal to uce_tpu's within
    fp32 round-off."""
    from uce_tpu.diffusion.guidance import DEBIAS_VL_DEFAULT_PROFESSIONS
    from uce_tpu.eval import baselines as jb
    from uce_tpu_torch.diffusion.pipeline import SDPipeline

    snap, prompts, jpipe = rig
    jb.generate_debias_vl(jpipe, prompts, DEBIAS_VL_DEFAULT_PROFESSIONS,
                          str(tmp_path / "want"), model_name="diffusers-tiny",
                          ddim_steps=3, image_size=32, num_samples=1, till_case=3)
    assert cli_main(["debias-vl", "--model_name", snap, "--prompts_path", prompts,
                     "--save_path", str(tmp_path / "got"), "--ddim_steps", "3",
                     "--till_case", "3", *COMMON]) == 0
    assert "Using default train list" in capsys.readouterr().out
    _same_folders(tmp_path / "got", tmp_path / "want", "tiny", ["0_0.png"])
    pipe = SDPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    proj = baselines.debias_vl_projection(pipe, ["Doctor", "Nurse"])
    assert proj.shape == (32, 32) and proj.dtype == np.float64
    assert np.abs(proj - np.eye(32)).max() > 0.1


def test_debias_vl_rejects_sdxl():
    class FakeSDXL:
        is_sdxl = True

    with pytest.raises(ValueError, match="SD 1.x/2.x"):
        baselines.generate_debias_vl(FakeSDXL(), "unused.csv", ["doctor"], "/tmp/unused")


@pytest.mark.parametrize("batch", [3, 5, 10])
def test_unet_calls_at_baseline_batches(batch):
    """SD 1.4's UNet at batch 3 (SLD, one image), 5 and 10 (concept algebra,
    one and two images): 49 convs, 61 GroupNorms and 10 self-attentions on
    the kernels per forward, as at batch 2; every conv and GroupNorm shape
    gets a valid plan."""
    conv_calls, gn_calls, attns = _calls("sd14", "unet", batch)
    assert sum(conv_calls.values()) == 49 and sum(gn_calls.values()) == 61
    routed = _kernel_attention(attns)
    assert {q: n for (q, _), n in routed.items()} == {
        (batch, 8, 4096, 40): 5, (batch, 8, 1024, 80): 5}
    for (shape, cout), _ in conv_calls.items():
        p = port_conv.plan(*shape, cout, SMS)
        assert (p.variant == "mma") == (shape[3] == 4)
        assert p.splits == 1 or p.m_tiles * p.n_tiles * p.splits <= SMS
    for (shape, groups), _ in gn_calls.items():
        assert port_gn.supported_shape(shape, groups, torch.bfloat16)
        p = port_gn.plan(shape, groups)
        assert 1 <= p.cluster <= 16 and p.smem <= 227 * 1024


@pytest.mark.parametrize("batch", [1, 2])
def test_vae_calls_at_baseline_batches(batch):
    conv_calls, gn_calls, attns = _calls("sd14", "vae", batch)
    assert sum(conv_calls.values()) == 33 and sum(gn_calls.values()) == 28
    assert {q: n for (q, _), n in _kernel_attention(attns).items()} == {
        (batch, 1, 4096, 512): 1}
