"""The port's Newton-Schulz edit matrix (the uce_solve kernel's plain version
on CPU tensors), its general per-layer solves and the edit-sd --method /
--apply_on options against uce_tpu.

Tolerances: Newton-Schulz against the Pallas kernel < 5e-3 relative, the
bar of tests/test_pallas_solve.py (both refine once, but the fp32 Newton
floor differs with the matmul order); the Cholesky solves ~1e-4 relative,
fp32 round-off at these sizes."""

import functools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.snapshot import make_sd_snapshot
from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.edit import sd as jedit
from uce_tpu.ops import solver as jsolver
from uce_tpu.ops.pallas.uce_solve import uce_edit_matrix_pallas as jax_pallas
from uce_tpu_torch.edit import sd as tedit
from uce_tpu_torch.ops import kernels, solver as tsolver
from uce_tpu_torch.ops.kernels import uce_solve as port_solve


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _solve_case(k, p, d):
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((k, d), (k, d), (p, d)))


@functools.cache
def _pallas_edit_matrix(k, p, d):
    """The Pallas kernel's edit matrix (interpret mode) on ``_solve_case``,
    computed once for the tests that share it."""
    c_edit, c_guide, c_pres = _solve_case(k, p, d)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_pallas(jnp.asarray(c_edit), jnp.asarray(c_guide),
                                     jnp.asarray(c_pres), 1.3, 0.7, 0.5))


@pytest.mark.parametrize("k,p,d", [(4, 3, 256), (16, 0, 256)])
def test_newton_schulz_matches_pallas_kernel(k, p, d):
    c_edit, c_guide, c_pres = _solve_case(k, p, d)
    want = _pallas_edit_matrix(k, p, d)
    kernels.reset_launches()
    got = port_solve.uce_edit_matrix_pallas(_t(c_edit), _t(c_guide), _t(c_pres),
                                            1.3, 0.7, 0.5).numpy()
    assert not any(kernels.launches().values())  # a CPU tensor takes the plain version
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 5e-3
    chol = tsolver.uce_edit_matrix(_t(c_edit), _t(c_guide), _t(c_pres), 1.3, 0.7,
                                   0.5).numpy()
    assert np.abs(got - chol).max() / scale < 5e-3


def _tf32(x):
    """fp32 -> TF32 value (10 explicit mantissa bits), rounded to nearest
    with ties away from zero on the int32 view (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the kernel's GEMM forms it: big = tf32(x), small =
    tf32(x - big) for each operand, and small.big + big.small + big.big,
    each product exact in fp32 (two 11-bit significands), summed in fp32."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    with tsolver.full_fp32():
        return a_s @ bb + ab @ b_s + ab @ bb


def _newton_schulz_3xtf32(c_edit, c_pres, erase_scale, preserve_scale, lamb):
    """The kernel chain with its GEMMs emulated in 3xTF32 (the Gram build,
    the norm and X_0 are fp32, as in the kernel)."""
    d = c_edit.shape[1]
    eye = torch.eye(d, dtype=torch.float32)
    with tsolver.full_fp32():
        b = (erase_scale * (c_edit.T @ c_edit)
             + preserve_scale * (c_pres.T @ c_pres) + lamb * eye)
    x = eye / b.abs().sum(dim=1).max()
    for _ in range(port_solve.NEWTON_ITERS):
        x = _matmul_3xtf32(x, 2.0 * eye - _matmul_3xtf32(b, x))
    return x


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12)])
    # 1 + 2^-11 is a tie between 1 and 1 + 2^-10: away from zero
    assert _tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("k,p,d", [(4, 3, 256), (16, 0, 256)])
def test_newton_schulz_3xtf32_meets_the_fp32_bar(k, p, d, monkeypatch):
    """The 3xTF32 split of the uce_solve kernel's GEMMs, emulated here, stays
    within chip_smoke.py's 1e-3 of the fp32 plain version, and its edit
    matrix within this file's 5e-3 of the Pallas kernel."""
    c_edit, c_guide, c_pres = _solve_case(k, p, d)
    args = (_t(c_edit), _t(c_pres), 1.3, 0.7, 0.5)
    x = _newton_schulz_3xtf32(*args)
    ref = port_solve.newton_schulz_reference(*args)
    assert float((x - ref).abs().max() / ref.abs().max()) < 1e-3
    # the control: one TF32 product per GEMM stalls far from that bar
    eye = torch.eye(d)
    b = 1.3 * args[0].T @ args[0] + 0.7 * args[1].T @ args[1] + 0.5 * eye
    x1 = eye / b.abs().sum(dim=1).max()
    with tsolver.full_fp32():
        for _ in range(port_solve.NEWTON_ITERS):
            x1 = _tf32(x1) @ _tf32(2.0 * eye - _tf32(b) @ _tf32(x1))
    assert float((x1 - ref).abs().max() / ref.abs().max()) > 1e-3
    want = _pallas_edit_matrix(k, p, d)
    monkeypatch.setattr(port_solve, "newton_schulz_inverse",
                        lambda *a: _newton_schulz_3xtf32(*a))
    got = port_solve.uce_edit_matrix_pallas(_t(c_edit), _t(c_guide), _t(c_pres),
                                            1.3, 0.7, 0.5).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-3


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
