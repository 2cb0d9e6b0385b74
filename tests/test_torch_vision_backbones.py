"""The port's eval backbones (uce_tpu_torch/models/vision_backbones.py)
against uce_tpu's on the same torchvision-format random weights and inputs,
at tests/test_vision_cross_impl.py's tolerances: the AlexNet and VGG19
taps, ResNet-50's logits, the bilinear resize (down and up) and
``preprocess_imagenet``; and models/convert.py's carry of uce_tpu's trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uce_tpu.models import vision_backbones as jvb
from uce_tpu_torch.models import convert
from uce_tpu_torch.models import vision_backbones as tvb


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.numpy().transpose(0, 2, 3, 1)


def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(99)
    return rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


def test_alexnet_taps(images):
    sd = tvb.init_alexnet_state_dict(np.random.default_rng(0))
    jparams = jvb.convert_alexnet(sd)
    tparams = tvb.convert_alexnet(sd)
    _equal_trees(convert.alexnet_params(jparams), tparams)
    want = jvb.alexnet_features(jparams, images)
    got = tvb.alexnet_features(tparams, _nchw(images))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"alexnet tap {i}")


def test_vgg19_taps(images):
    sd = tvb.init_vgg19_state_dict(np.random.default_rng(1))
    five = {k: v for k, v in sd.items() if int(k.split(".")[1]) <= 10}  # conv_1..5
    jparams = jvb.convert_vgg19(five)
    tparams = tvb.convert_vgg19(five)
    assert sorted(tparams) == [f"conv{i}" for i in range(5)]
    assert len(tvb.convert_vgg19(sd)) == 16
    _equal_trees(convert.vgg19_params(jparams), tparams)
    want = jvb.vgg19_features(jparams, images, num_convs=5)
    got = tvb.vgg19_features(tparams, _nchw(images), num_convs=5)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"vgg conv_{i + 1}")


def test_resnet50_logits():
    """ResNet-50 at its published widths on a small input (64², for CPU
    time): logits at the cross-impl bars and the same top-5."""
    sd = tvb.init_resnet50_state_dict(np.random.default_rng(2))
    sd["layer1.0.bn1.running_mean"] = np.full(64, 0.1, np.float32)
    sd["layer1.0.bn1.running_var"] = np.full(64, 2.0, np.float32)
    jparams = jvb.convert_resnet50(sd)
    tparams = tvb.convert_resnet50(sd)
    _equal_trees(convert.resnet50_params(jparams), tparams)
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jvb.resnet50_logits(jparams, x))
    with torch.inference_mode():
        got = tvb.resnet50_logits(tparams, _nchw(x)).numpy()
    assert got.shape == (2, 1000)
    assert want.std() > 1.0  # the logits spread: top-k is not a tie
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    np.testing.assert_array_equal(np.argsort(-got, 1)[:, :5], np.argsort(-want, 1)[:, :5])


@pytest.mark.parametrize("src,dst", [((512, 512), (64, 64)), ((512, 512), (256, 256)),
                                     ((48, 40), (224, 224)), ((100, 150), (77, 61)),
                                     ((64, 64), (64, 64))])
def test_resize_matches_jax_bilinear(src, dst):
    """``jax.image.resize(method="bilinear")`` antialiases when it shrinks:
    F.interpolate(bilinear, antialias=True) down, up, non-square and at the
    same size."""
    x = np.random.default_rng(8).uniform(0, 1, (2, *src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="bilinear"))
    got = _nhwc(tvb.resize_bilinear(_nchw(x), dst))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("shape,size", [((2, 512, 512), 224), ((1, 100, 150), 224),
                                        ((1, 300, 200), 128)])
def test_preprocess_imagenet(shape, size):
    """Resize of the shorter side (256 for 224, with int(round(h*scale))),
    the floor-halved centre crop and the ImageNet normalization."""
    raw = np.random.default_rng(9).integers(0, 256, (*shape, 3), dtype=np.uint8)
    want = np.asarray(jvb.preprocess_imagenet(raw, size))
    got = _nhwc(tvb.preprocess_imagenet(raw, size, device="cpu"))
    assert got.shape == want.shape == (shape[0], size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_max_pool_pads_with_minus_inf():
    x = -torch.arange(1.0, 26.0).view(1, 1, 5, 5)
    want = np.asarray(jvb.max_pool(jnp.asarray(_nhwc(x)), 3, 2, 1))
    np.testing.assert_array_equal(_nhwc(tvb.max_pool(x, 3, 2, 1)), want)
