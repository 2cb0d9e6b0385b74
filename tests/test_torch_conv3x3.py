"""The port's conv3x3 kernel wrapper on CPU tensors (its plain version)
against uce_tpu's Pallas conv3x3 in interpret mode, on the cases of
tests/test_pallas_conv.py plus the ragged channel counts of SD's latent
convs (Cin=4, Cout=4, Cout=3). Tolerance rtol/atol 0.05, as there: bf16
outputs; the port adds the bias in fp32 before its one rounding, the Pallas
path adds it in bf16 after."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uce_tpu.ops.pallas import conv3x3 as pallas_conv
from uce_tpu_torch.ops.kernels import conv3x3 as port_conv

TOL = dict(rtol=0.05, atol=0.05)


def _bf16_pair(a):
    """numpy -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


def _run(x, w_hwio, bias):
    xj, xt = _bf16_pair(x)
    wj, wt = _bf16_pair(w_hwio)
    bj, bt = _bf16_pair(bias) if bias is not None else (None, None)
    want = np.asarray(pallas_conv.conv3x3(xj, wj, bj, interpret=True), np.float32)
    # HWIO -> OIHW (diffusers) -> the port's packed [Cout, 3, 3, Cin]
    w_oihw = wt.permute(3, 2, 0, 1)
    port_conv.launches = 0
    got = port_conv.conv3x3(xt, port_conv.pack_weight(w_oihw), bt)
    assert port_conv.launches == 0  # a CPU tensor takes the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    return got.float().numpy(), want


def test_matches_pallas_kernel():
    rng = np.random.default_rng(11)
    got, want = _run(rng.standard_normal((2, 8, 8, 12)),
                     rng.standard_normal((3, 3, 12, 20)) * 0.1,
                     rng.standard_normal(20) * 0.1)
    np.testing.assert_allclose(got, want, **TOL)


def test_center_tap_only_writes_every_channel():
    rng = np.random.default_rng(11)
    w = np.zeros((3, 3, 4, 20), np.float32)
    w[1, 1] = rng.standard_normal((4, 20))
    got, want = _run(rng.standard_normal((1, 6, 6, 4)), w, None)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[..., 10:]).sum() > 0


@pytest.mark.parametrize("cin,cout", [
    (4, 32),    # UNet conv_in, VAE decoder.conv_in
    (32, 4),    # UNet conv_out
    (32, 3),    # VAE decoder.conv_out
    (24, 40),
])
def test_ragged_channels_match_pallas_kernel(cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    got, want = _run(rng.standard_normal((2, 7, 9, cin)),
                     rng.standard_normal((3, 3, cin, cout)) * 0.2,
                     rng.standard_normal(cout) * 0.1)
    np.testing.assert_allclose(got, want, **TOL)


def test_pack_weight_layout():
    w = torch.arange(2 * 3 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3, 3)
    packed = port_conv.pack_weight(w)
    assert packed.is_contiguous() and tuple(packed.shape) == (2, 3, 3, 3)
    assert torch.equal(packed[1, 2, 0, :], w[1, :, 2, 0])


def test_rejects_mismatched_weights():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        port_conv.conv3x3(x, torch.zeros(4, 3, 3, 6, dtype=torch.bfloat16))
