"""The port's FLUX edit (uce_tpu_torch/edit/flux.py, ``edit-flux``) against
uce_tpu's on tests/snapshot.py's tiny FLUX snapshot: the two-stream concept
embeddings (T5 last real token, CLIP pooled), the per-input-dim collapsed
solve, and both CLIs writing the same keys and values. fp32 tolerances:
embeddings rtol = atol = 2e-4 (tests/test_unet_cross_impl.py's module bar);
edited weights rtol = atol = 1e-4 relative to the targets' scale (fp32
solves of the same Gram matrices)."""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu_torch.edit import flux as tflux_edit

EDITS, GUIDES, PRESERVES = ["kelly mckernan", "tyler edlin"], ["art", "art"], ["van gogh"]


@pytest.fixture(scope="module")
def flux_snap(tmp_path_factory):
    from tests.snapshot import make_flux_snapshot

    return make_flux_snapshot(tmp_path_factory.mktemp("torch_edit_flux_snap"))


@pytest.fixture(scope="module")
def resources(flux_snap):
    from uce_tpu.edit import flux as jflux_edit

    return (jflux_edit.load_resources(flux_snap),
            tflux_edit.load_resources(flux_snap, device="cpu"))


def test_default_max_sequence_length(tmp_path):
    from uce_tpu.edit import flux as jflux_edit

    for name in ("FLUX.1-schnell", "FLUX.1-dev"):
        assert (tflux_edit.default_max_sequence_length(name)
                == jflux_edit.default_max_sequence_length(name))
    for name, guidance, expect in [("flux-fast", False, 256), ("my-schnell-copy", True, 512)]:
        os.makedirs(tmp_path / name / "transformer")
        (tmp_path / name / "transformer" / "config.json").write_text(
            json.dumps({"guidance_embeds": guidance}))
        assert tflux_edit.default_max_sequence_length(str(tmp_path / name)) == expect


def test_load_resources_reads_the_two_targets(resources):
    jres, tres = resources
    assert list(tres.targets) == list(jres.targets) == [
        "context_embedder.weight", "time_text_embed.text_embedder.linear_1.weight"]
    for k, v in tres.targets.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), jres.targets[k])
    assert tres.max_sequence_length == jres.max_sequence_length == 256


def test_encode_concepts_matches_uce_tpu(resources):
    from uce_tpu.edit import flux as jflux_edit

    jres, tres = resources
    concepts = EDITS + GUIDES + PRESERVES
    want = jflux_edit.encode_concepts(jres, concepts)
    got = tflux_edit.encode_concepts(tres, concepts)
    assert list(got) == list(want) == list(dict.fromkeys(concepts))
    for c in want:
        assert sorted(got[c]) == sorted(want[c]) == [16, 24]
        for dim in want[c]:
            np.testing.assert_allclose(got[c][dim].numpy(), np.asarray(want[c][dim]),
                                       rtol=2e-4, atol=2e-4)


def test_erase_from_embeddings_matches_uce_tpu(resources):
    """The same (uce_tpu's) embeddings through both solvers."""
    from uce_tpu.edit import flux as jflux_edit

    jres, tres = resources
    embeds = jflux_edit.encode_concepts(jres, EDITS + GUIDES + PRESERVES)
    want = jflux_edit.erase_from_embeddings(jres.targets, embeds, EDITS, GUIDES,
                                            PRESERVES, erase_scale=2.0, lamb=0.3)
    t_embeds = {c: {d: torch.tensor(np.array(v)) for d, v in e.items()}
                for c, e in embeds.items()}
    got = tflux_edit.erase_from_embeddings(tres.targets, t_embeds, EDITS, GUIDES,
                                           PRESERVES, erase_scale=2.0, lamb=0.3,
                                           device="cpu")
    assert list(got) == list(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy() / scale, want[k] / scale,
                                   rtol=1e-4, atol=1e-4)
        assert not np.allclose(got[k].numpy(), jres.targets[k])  # edited


def test_edit_flux_cli_matches_uce_tpu(flux_snap, tmp_path, monkeypatch):
    """Both CLIs' edit-flux write the same two diffusers keys; the values
    agree to fp32 round-off."""
    from safetensors.numpy import load_file

    from uce_tpu.cli.main import main as jmain
    from uce_tpu_torch.cli.main import main as tmain

    # uce_tpu's main() would point this worker's XLA cache at ~/.cache for
    # the rest of the process (tests/test_compile_cache.py then misses)
    monkeypatch.setenv("UCE_COMPILE_CACHE", "0")

    args = ["edit-flux", "--model_id", flux_snap, "--edit_concepts",
            "kelly mckernan; tyler edlin", "--concept_type", "art",
            "--preserve_concepts", "van gogh", "--exp_name", "erase"]
    assert jmain(args + ["--save_dir", str(tmp_path / "jax")]) == 0
    assert tmain(args + ["--save_dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    want = load_file(str(tmp_path / "jax" / "erase.safetensors"))
    got = load_file(str(tmp_path / "torch" / "erase.safetensors"))
    assert sorted(got) == sorted(want) == [
        "context_embedder.weight", "time_text_embed.text_embedder.linear_1.weight"]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("flag", [["--method", "pallas"], ["--method", "general"],
                                  ["--apply_on", "host"]])
def test_edit_flux_refuses_sd_only_flags(flux_snap, tmp_path, flag):
    from uce_tpu_torch.cli.main import main

    with pytest.raises(SystemExit, match="not supported for FLUX"):
        main(["edit-flux", "--model_id", flux_snap, "--edit_concepts", "a",
              "--concept_type", "art", "--save_dir", str(tmp_path), "--device", "cpu",
              *flag])
    assert not os.listdir(tmp_path)
