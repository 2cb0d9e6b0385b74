"""uce_tpu_torch attention against uce_tpu: the kernel's plain version
against the Pallas kernel (interpret mode), the plain attention path against
``_xla_attention``, and the ``impl="auto"`` routing rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uce_tpu.ops.attention import _xla_attention
from uce_tpu.ops.pallas import sd_attention as pallas_sdk
from uce_tpu_torch.ops import attention as port_attn
from uce_tpu_torch.ops.kernels import sd_attention as port_sdk


def _bf16_pair(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


# the five cases of tests/test_sd_attention.py::test_matches_xla
@pytest.mark.parametrize("b,h,sq,skv,d", [
    (2, 2, 256, 256, 40),
    (1, 4, 512, 512, 80),
    (2, 2, 64, 64, 160),
    (2, 2, 256, 77, 40),
    (1, 2, 512, 77, 160),
])
def test_reference_matches_pallas_kernel(b, h, sq, skv, d):
    rng = np.random.default_rng(11)
    qj, qt = _bf16_pair(rng.standard_normal((b, h, sq, d)))
    kj, kt = _bf16_pair(rng.standard_normal((b, h, skv, d)))
    vj, vt = _bf16_pair(rng.standard_normal((b, h, skv, d)))
    scale = d ** -0.5
    want = np.asarray(pallas_sdk.sd_attention(qj, kj, vj, scale, interpret=True),
                      np.float32)
    got = port_sdk.sd_attention(qt, kt, vt, scale)  # CPU tensor: plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    # tolerance of tests/test_sd_attention.py (bf16 outputs)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02, rtol=0.05)


def test_cpu_wrapper_launches_nothing():
    q = torch.randn(1, 1, 64, 40).bfloat16()
    port_sdk.launches = 0
    port_sdk.sd_attention(q, q, q, 40 ** -0.5)
    assert port_sdk.launches == 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(7, 7), (16, 9), (5, 12)])
def test_plain_matches_xla_attention(causal, tq, tk):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, tq, 8)).astype(np.float32)
    k = rng.standard_normal((2, 3, tk, 8)).astype(np.float32)
    v = rng.standard_normal((2, 3, tk, 8)).astype(np.float32)
    scale = 8 ** -0.5
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     None, causal, scale))
    got = port_attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale, impl="plain")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_plain_mask_matches_xla_attention():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 2, 6, 8)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((1, 1, 6, 6)) > 0.3
    mask[..., 0] = True
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(mask), False, 0.5))
    got = port_attn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask), scale=0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("q_shape,k_shape,want", [
    ((16, 8, 4096, 40), (16, 8, 4096, 40), True),    # 64x64 self-attention
    ((16, 8, 1024, 80), (16, 8, 1024, 80), True),    # 32x32 self-attention
    ((16, 8, 4096, 40), (16, 8, 77, 40), False),     # cross-attention
    ((16, 8, 256, 160), (16, 8, 256, 160), False),   # 16x16 self-attention
    ((1, 1, 4096, 512), (1, 1, 4096, 512), True),    # VAE mid-block (D split)
])
def test_auto_routing_rule(q_shape, k_shape, want):
    route = port_attn.routes_to_kernel
    assert route(q_shape, k_shape, torch.bfloat16, "cuda") is want
    # never on the CPU, in fp32, masked or causal
    assert not route(q_shape, k_shape, torch.bfloat16, "cpu")
    assert not route(q_shape, k_shape, torch.float32, "cuda")
    assert not route(q_shape, k_shape, torch.bfloat16, "cuda", masked=True)
    assert not route(q_shape, k_shape, torch.bfloat16, "cuda", causal=True)



def test_vae_head_dim_matches_xla_attention():
    """D = 512, one head (the VAE mid-block shape at a short sequence): the
    kernel wrapper's plain version against uce_tpu's ``_xla_attention``,
    which serves that call on the CPU; the bf16 tolerance of the cases
    above."""
    rng = np.random.default_rng(5)
    qj, qt = _bf16_pair(rng.standard_normal((2, 1, 96, 512)))
    kj, kt = _bf16_pair(rng.standard_normal((2, 1, 96, 512)))
    vj, vt = _bf16_pair(rng.standard_normal((2, 1, 96, 512)))
    scale = 512 ** -0.5
    want = np.asarray(_xla_attention(qj, kj, vj, None, False, scale), np.float32)
    got = port_sdk.sd_attention(qt, kt, vt, scale)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.02, rtol=0.05)


@pytest.mark.parametrize("d,want", [(512, True), (256, False), (48, False)])
def test_supported_head_dims(d, want):
    shape = (1, 1, 4096, d)
    assert port_sdk.supported_shape(shape, shape, torch.bfloat16) is want
