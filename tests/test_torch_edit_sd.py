"""The port's UCE solve, safetensors I/O and edit-sd CLI against uce_tpu."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.snapshot import make_sd_snapshot
from tests.test_goldens import GOLDEN_PATH
from uce_tpu_torch.models.hf_loader import (iter_safetensors_file, read_safetensors,
                                          save_safetensors)
from uce_tpu_torch.ops.solver import apply_edit_matrix, uce_edit_matrix


def test_edit_matrix_matches_golden():
    rng = np.random.default_rng(12345)
    c_e, c_g = rng.standard_normal((10, 64)), rng.standard_normal((10, 64))
    c_p = rng.standard_normal((5, 64))
    w = rng.standard_normal((24, 64)).astype(np.float32)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    golden = np.load(GOLDEN_PATH)
    e = uce_edit_matrix(t(c_e), t(c_g), t(c_p), 1.0, 1.0, 0.5)
    # the goldens' own tolerance (tests/test_goldens.py)
    np.testing.assert_allclose(e.numpy(), golden["edit_matrix"], rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(apply_edit_matrix(t(w), e).numpy(),
                               golden["edited_weight"], rtol=5e-5, atol=5e-5)


def test_extreme_scale_falls_back_to_lu():
    """erase_scale far past fp32 conditioning: the result stays finite."""
    rng = np.random.default_rng(0)
    c = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    e = uce_edit_matrix(c, c.flip(0), None, 1e9, 1.0, 1e-6)
    assert torch.isfinite(e).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_round_trip_with_the_library(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(1)
    tensors = {"b.weight": torch.from_numpy(rng.standard_normal((3, 5))).to(dtype),
               "a.bias": torch.from_numpy(rng.standard_normal(7)).to(dtype),
               "empty": torch.zeros((0, 4), dtype=dtype)}
    ours = tmp_path / "ours.safetensors"
    save_safetensors(tensors, str(ours))
    if dtype != torch.bfloat16:  # numpy has no bf16
        theirs = load_file(str(ours))
        for k, v in tensors.items():
            np.testing.assert_array_equal(theirs[k], v.numpy())
        lib = tmp_path / "lib.safetensors"
        save_file({k: v.numpy() for k, v in tensors.items()}, str(lib))
    else:
        lib = tmp_path / "lib.safetensors"
        save_torch(tensors, str(lib))
    for path in (ours, lib):
        back = read_safetensors(str(path))
        assert back.keys() == tensors.keys()
        for k, v in tensors.items():
            assert back[k].dtype == dtype and torch.equal(back[k], v)
        # one buffer for every tensor of the file, each copied out in turn
        reused = {k: t.clone() for k, t in iter_safetensors_file(str(path), reuse=True)}
        assert all(torch.equal(reused[k], v) for k, v in tensors.items())


@pytest.fixture(scope="module")
def sd_snap(tmp_path_factory):
    return make_sd_snapshot(tmp_path_factory.mktemp("torch_edit_snap"))


def test_edit_sd_cli_matches_uce_tpu(sd_snap, tmp_path):
    from safetensors.numpy import load_file

    from uce_tpu.edit import sd as jedit
    from uce_tpu.utils.prompts import resolve_edit_request

    args = ["--edit_concepts", "cat; Van Gogh", "--concept_type", "art",
            "--preserve_concepts", "dog; a house", "--erase_scale", "3"]
    proc = subprocess.run(
        [sys.executable, "-m", "uce_tpu_torch", "edit-sd", "--model_id", sd_snap,
         *args, "--save_dir", str(tmp_path), "--exp_name", "port",
         "--device", "cpu"], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ours = load_file(str(tmp_path / "port.safetensors"))

    edits, guides, preserves = resolve_edit_request(
        "cat; Van Gogh", None, "dog; a house", "art")
    want = jedit.run_erase(jedit.load_resources(sd_snap), edits, guides,
                           preserves, erase_scale=3.0)
    assert list(ours) == sorted(want) and len(ours) == 8
    assert all(k.endswith((".to_k.weight", ".to_v.weight")) for k in ours)
    for k, v in want.items():
        # the fp32 solver agreement of the verify recipe (~1e-3 relative)
        np.testing.assert_allclose(ours[k], np.asarray(v), rtol=1e-3, atol=1e-5)
        assert not np.allclose(ours[k], load_file(
            f"{sd_snap}/unet/diffusion_pytorch_model.safetensors")[k])


def test_cuda_device_without_cuda_fails(sd_snap, tmp_path, monkeypatch):
    from uce_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["edit-sd", "--model_id", sd_snap, "--edit_concepts", "cat",
              "--concept_type", "object", "--save_dir", str(tmp_path)])
    assert not list(tmp_path.glob("*.safetensors"))


def _random_embeds(d: int):
    rng = np.random.default_rng(d)
    names = ["e0", "e1", "g0", "p0", "p1"]
    embeds = {n: torch.from_numpy(rng.standard_normal(d).astype(np.float32))
              for n in names}
    targets = {f"l{i}.to_k.weight": torch.from_numpy(
        rng.standard_normal((16, d)).astype(np.float32) * 0.02) for i in range(2)}
    return targets, embeds, (["e0", "e1"], ["g0", "g0"], ["p0", "p1"])


def test_pallas_above_max_dim_takes_the_collapsed_solve(caplog, monkeypatch):
    """uce_tpu's rule, by shape: past MAX_PALLAS_DIM (SDXL's d=2048) the
    pallas method returns the collapsed solve and logs why; the kernel's
    wrapper is never called."""
    from uce_tpu_torch.edit import sd as edit_sd

    monkeypatch.setattr(edit_sd, "uce_edit_matrix_pallas", None)  # a call fails
    targets, embeds, concepts = _random_embeds(edit_sd.MAX_PALLAS_DIM + 8)
    with caplog.at_level("WARNING", logger="uce_tpu_torch.edit.sd"):
        got = edit_sd.erase_from_embeddings(targets, embeds, *concepts,
                                            device="cpu", method="pallas")
    assert "pallas edit kernel needs d <= 1024 (got d=1032)" in caplog.text
    want = edit_sd.erase_from_embeddings(targets, embeds, *concepts, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k])


def test_pallas_at_max_dim_takes_the_kernel_path(caplog, monkeypatch):
    """At d = MAX_PALLAS_DIM (SD 2.x's 1024) the pallas method runs the
    Newton-Schulz wrapper (its plain version on a CPU tensor), with no
    warning, within the edit bar of collapsed."""
    from uce_tpu_torch.edit import sd as edit_sd
    from uce_tpu_torch.ops.kernels import uce_solve

    calls = []

    def spy(c_edit, *args):
        calls.append(c_edit.shape)
        return uce_solve.uce_edit_matrix_pallas(c_edit, *args)

    monkeypatch.setattr(edit_sd, "uce_edit_matrix_pallas", spy)
    targets, embeds, concepts = _random_embeds(edit_sd.MAX_PALLAS_DIM)
    with caplog.at_level("WARNING", logger="uce_tpu_torch.edit.sd"):
        got = edit_sd.erase_from_embeddings(targets, embeds, *concepts,
                                            device="cpu", method="pallas")
    assert calls == [(2, 1024)] and "pallas edit kernel" not in caplog.text
    want = edit_sd.erase_from_embeddings(targets, embeds, *concepts, device="cpu")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5)
