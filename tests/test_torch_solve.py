"""The port's Newton-Schulz edit matrix (the uce_solve kernel's plain version
on CPU tensors), its general per-layer solves and the edit-sd --method /
--apply_on options against uce_tpu.

Tolerances: Newton-Schulz against the Pallas kernel < 5e-3 relative, the
bar of tests/test_pallas_solve.py (both refine once, but the fp32 Newton
floor differs with the matmul order); the Cholesky solves ~1e-4 relative,
fp32 round-off at these sizes."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.snapshot import make_sd_snapshot
from uce_tpu.edit import sd as jedit
from uce_tpu.ops import solver as jsolver
from uce_tpu.ops.pallas.uce_solve import uce_edit_matrix_pallas as jax_pallas
from uce_tpu_torch.edit import sd as tedit
from uce_tpu_torch.ops import solver as tsolver
from uce_tpu_torch.ops.kernels import uce_solve as port_solve


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("k,p,d", [(4, 3, 256), (16, 0, 256)])
def test_newton_schulz_matches_pallas_kernel(k, p, d):
    rng = np.random.default_rng(0)
    c_edit = rng.standard_normal((k, d)).astype(np.float32)
    c_guide = rng.standard_normal((k, d)).astype(np.float32)
    c_pres = rng.standard_normal((p, d)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_pallas(jnp.asarray(c_edit), jnp.asarray(c_guide),
                                     jnp.asarray(c_pres), 1.3, 0.7, 0.5))
    port_solve.launches = 0
    got = port_solve.uce_edit_matrix_pallas(_t(c_edit), _t(c_guide), _t(c_pres),
                                            1.3, 0.7, 0.5).numpy()
    assert port_solve.launches == 0  # a CPU tensor takes the plain version
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 5e-3
    chol = tsolver.uce_edit_matrix(_t(c_edit), _t(c_guide), _t(c_pres), 1.3, 0.7,
                                   0.5).numpy()
    assert np.abs(got - chol).max() / scale < 5e-3


def test_newton_schulz_inverse_reference():
    rng = np.random.default_rng(1)
    c_edit, c_pres = _t(rng.standard_normal((6, 64))), _t(rng.standard_normal((2, 64)))
    x = port_solve.newton_schulz_inverse(c_edit, c_pres, 1.0, 1.0, 0.5)
    b = c_edit.T @ c_edit + c_pres.T @ c_pres + 0.5 * torch.eye(64)
    assert float((b @ x - torch.eye(64)).abs().max()) < 1e-3


def test_rejects_oversize():
    z = torch.zeros((1, 2048))
    with pytest.raises(ValueError, match="supports d"):
        port_solve.uce_edit_matrix_pallas(z, z, z, 1.0, 1.0, 0.5)


def test_solve_layer_and_stacked_match_uce_tpu():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 10, 16)).astype(np.float32)
    c_edit = rng.standard_normal((4, 16)).astype(np.float32)
    v_guide = rng.standard_normal((3, 4, 10)).astype(np.float32)
    c_pres = rng.standard_normal((2, 16)).astype(np.float32)
    scales = np.array([1.0, 2.0, 0.5, 3.0], np.float32)
    want = np.asarray(jsolver.uce_solve_stacked(w, c_edit, v_guide, c_pres,
                                                erase_scale=scales, lamb=0.3))
    got = tsolver.uce_solve_stacked(_t(w), _t(c_edit), _t(v_guide), _t(c_pres),
                                    erase_scale=_t(scales), lamb=0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want1 = np.asarray(jsolver.uce_solve_layer(w[1], c_edit, v_guide[1]))
    got1 = tsolver.uce_solve_layer(_t(w[1]), _t(c_edit), _t(v_guide[1])).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-4, atol=1e-4)


def _erase_case():
    rng = np.random.default_rng(3)
    targets = {"a.to_k.weight": rng.standard_normal((8, 32)),
               "a.to_v.weight": rng.standard_normal((8, 32)),
               "b.to_k.weight": rng.standard_normal((12, 32))}
    targets = {k: v.astype(np.float32) for k, v in targets.items()}
    names = ["cat", "dog", "", "van gogh", "house"]
    embeds = {n: rng.standard_normal(32).astype(np.float32) for n in names}
    return targets, embeds, ["cat", "van gogh"], ["", ""], ["dog", "house"]


@pytest.mark.parametrize("method,apply_on", [
    ("general", "device"),
    ("collapsed", "host"),
    ("pallas", "host"),
])
def test_erase_methods_match_uce_tpu(method, apply_on):
    targets, embeds, edits, guides, preserves = _erase_case()
    want = jedit.erase_from_embeddings(targets, embeds, edits, guides, preserves,
                                       2.0, 1.0, 0.5, method="collapsed")
    got = tedit.erase_from_embeddings(
        {k: _t(v) for k, v in targets.items()}, {k: _t(v) for k, v in embeds.items()},
        edits, guides, preserves, 2.0, 1.0, 0.5, "cpu", method, apply_on)
    assert list(got) == list(targets)
    ref = jedit.erase_from_embeddings(targets, embeds, edits, guides, preserves,
                                      2.0, 1.0, 0.5, method="general",
                                      apply_on=apply_on)
    for k in targets:
        np.testing.assert_allclose(np.asarray(ref[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)
        # pallas: the Newton-Schulz bar; the Cholesky paths: fp32 round-off
        tol = 5e-3 if method == "pallas" else 1e-4
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol)


def test_erase_rejects_unknown_options():
    targets, embeds, edits, guides, preserves = _erase_case()
    args = ({k: _t(v) for k, v in targets.items()},
            {k: _t(v) for k, v in embeds.items()}, edits, guides, preserves)
    with pytest.raises(ValueError, match="method"):
        tedit.erase_from_embeddings(*args, method="lu")
    with pytest.raises(ValueError, match="apply_on"):
        tedit.erase_from_embeddings(*args, apply_on="disk")


@pytest.fixture(scope="module")
def sd_snap(tmp_path_factory):
    return make_sd_snapshot(tmp_path_factory.mktemp("torch_solve_snap"))


@pytest.mark.parametrize("method", ["pallas", "general"])
def test_edit_sd_cli_method(sd_snap, tmp_path, method):
    from safetensors.numpy import load_file

    common = ["edit-sd", "--model_id", sd_snap, "--edit_concepts", "cat; Van Gogh",
              "--concept_type", "art", "--preserve_concepts", "dog; a house",
              "--save_dir", str(tmp_path), "--device", "cpu"]
    for name, extra in ((method, ["--method", method, "--apply_on", "host"]),
                        ("collapsed", [])):
        proc = subprocess.run([sys.executable, "-m", "uce_tpu_torch", *common,
                               "--exp_name", name, *extra],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
    got = load_file(str(tmp_path / f"{method}.safetensors"))
    want = load_file(str(tmp_path / "collapsed.safetensors"))
    unet = load_file(f"{sd_snap}/unet/diffusion_pytorch_model.safetensors")
    n_targets = sum(k.endswith(("attn2.to_k.weight", "attn2.to_v.weight"))
                    for k in unet)
    assert list(got) == list(want) and len(got) == n_targets
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=5e-3)
