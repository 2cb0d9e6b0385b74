"""The port's group_norm_act kernel wrapper on CPU tensors (its plain
version) against uce_tpu's Pallas kernel in interpret mode, on the cases of
tests/test_pallas_group_norm.py. Tolerance atol 0.06, rtol 0.05, as there:
bf16 outputs, and the two sides round x*gamma+beta and the SiLU at
different places."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uce_tpu.ops.pallas import group_norm as pallas_gn
from uce_tpu_torch.ops.kernels import group_norm as port_gn

TOL = dict(atol=0.06, rtol=0.05)


def _bf16_pair(a):
    """numpy -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _compare(x, scale, bias, groups, eps, act):
    xj, xt = _bf16_pair(x)
    sj, st = _bf16_pair(scale)
    bj, bt = _bf16_pair(bias)
    want = np.asarray(pallas_gn.group_norm_act(xj, sj, bj, groups, eps, act,
                                               interpret=True), np.float32)
    port_gn.launches = 0
    got = port_gn.group_norm_act(xt, st, bt, groups, eps, act)
    assert port_gn.launches == 0  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), want


@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 64), 8),
    ((3, 4, 4, 320), 32),
    ((1, 16, 16, 128), 32),
])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_matches_pallas_kernel(shape, groups, act):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape) * 2 + 0.5
    c = shape[-1]
    got, want = _compare(x, rng.standard_normal(c), rng.standard_normal(c),
                         groups, 1e-5, act)
    np.testing.assert_allclose(got, want, **TOL)


def test_zero_variance_takes_eps():
    x = np.full((1, 4, 4, 32), 3.0)
    got, want = _compare(x, np.ones(32), np.zeros(32), 8, 1e-2, "none")
    np.testing.assert_allclose(got, 0.0, atol=1e-2)
    np.testing.assert_allclose(got, want, **TOL)


def test_row_tiling_case():
    """24x24 maps: H*W not a multiple of the TPU kernel's row tile."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 24, 24, 64))
    got, want = _compare(x, rng.standard_normal(64), rng.standard_normal(64), 8,
                         1e-5, "none")
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,groups,want", [
    ((4, 64, 64, 320), 32, True),     # UNet, 64x64 level
    ((4, 32, 32, 1920), 32, True),    # UNet up path, concatenated skips
    ((4, 8, 8, 2560), 32, True),
    ((1, 512, 512, 128), 32, True),   # VAE, last up block
    ((2, 8, 8, 65), 8, False),        # C % groups
    ((2, 8, 8, 36), 4, False),        # C % 8 (16-byte vectors)
])
def test_supported_shape(shape, groups, want):
    assert port_gn.supported_shape(shape, groups, torch.bfloat16) is want
    assert not port_gn.supported_shape(shape, groups, torch.float32)


def test_rejects_unknown_act():
    x = torch.zeros(1, 2, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="act"):
        port_gn.group_norm_act(x, torch.ones(8), torch.zeros(8), 4, 1e-5, "gelu")
