"""uce_tpu_torch.models.layers against uce_tpu.models.layers in fp32.

uce_tpu is NHWC with HWIO kernels; the port is NCHW with OIHW kernels.
The tests own the transposes. Tolerance: fp32 roundoff, atol/rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import layers as jl
from uce_tpu_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("stride,padding,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1)])
def test_conv2d(stride, padding, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 9, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6, k, k)).astype(np.float32)  # OIHW
    b = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(jl.conv2d(jnp.asarray(x), jnp.asarray(jl.conv_kernel(w)),
                                jnp.asarray(b), stride=stride, padding=padding))
    got = tl.conv2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b),
                    stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_act(act, eps):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 6, 5, 16)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(jl.group_norm_act(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(bias), 4, eps, act=act))
    got = tl.group_norm_act(_nchw(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), 4, eps, act=act)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)


def test_layer_norm():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 7, 24)) * 2 - 1).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    want = np.asarray(jl.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias)))
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_linear():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    w = rng.standard_normal((6, 8)).astype(np.float32)  # [out, in]
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jl.linear(jnp.asarray(x), jnp.asarray(jl.linear_weight(w)),
                                jnp.asarray(b)))
    got = tl.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0.0), (33, False, 1.0)])
def test_timestep_embedding(dim, flip, shift):
    t = np.array([0.0, 1.0, 481.0, 999.0], np.float32)
    want = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim, flip, shift))
    got = tl.timestep_embedding(torch.from_numpy(t), dim, flip, shift)
    # sin/cos of args up to ~1e3 in fp32: the two libraries' argument
    # reduction differs by a few ulp of the argument
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
