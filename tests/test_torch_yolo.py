"""The port's YOLOv8 detector (uce_tpu_torch/models/yolo.py) against
uce_tpu's on the same seeded weights (carried across by each side's
``params_from_state``) at tiny widths: the forward and decode at fp32
tolerances, the letterbox canvas within one uint8 level (the scale and pads
exactly), NMS and postprocessing exactly, and the same key checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401
from uce_tpu.models import yolo as jyolo
from uce_tpu_torch.models import yolo

TINY = dict(widths=(4, 8, 16, 16, 32), depths=(1, 1, 1, 1), nc=18)
# fp32 on both sides; 24 convs deep, sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_state():
    return yolo.init_yolo_state(seed=3, **TINY)


def test_init_state_is_uce_tpus(tiny_state):
    want = jyolo.init_yolo_state(seed=3, **TINY)
    assert tiny_state.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(tiny_state[k], want[k])


def test_forward_and_decode_match_uce_tpu(tiny_state):
    """yolo_raw's per-scale maps, decode and yolo_detect on a batch of two
    64x64 inputs (anchors 8², 4², 2²)."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jparams = jyolo.params_from_state(tiny_state)
    want_raw = jax.jit(jyolo.yolo_raw)(jparams, jnp.asarray(x))
    want = np.asarray(jax.jit(jyolo.decode)(want_raw))
    params = yolo.params_from_state(tiny_state, "cpu")
    raw = yolo.yolo_raw(params, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(r.shape) for r in raw] == [
        (2, 64 + 18, s, s) for s in (8, 4, 2)]
    for got, ref in zip(raw, want_raw):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)
    got = yolo.decode(raw).numpy()
    assert got.shape == (2, 84, 4 + 18)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        yolo.decode([torch.from_numpy(np.array(r)).permute(0, 3, 1, 2)
                     for r in want_raw]).numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        yolo.yolo_detect(params, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(), got)


@pytest.mark.parametrize("hw", [(48, 80), (96, 40), (64, 64), (200, 120), (7, 5)])
def test_letterbox_matches_uce_tpu(hw):
    """Downscales, an upscale and a square: the scale and pads equal, the
    canvas within one uint8 level (PIL's bilinear against the port's
    antialiased resize)."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), np.uint8)
    canvas, scale, px, py = yolo.letterbox(img, 64)
    want, wscale, wpx, wpy = jyolo.letterbox(img, 64)
    assert (scale, px, py) == (wscale, wpx, wpy)
    assert canvas.shape == want.shape == (64, 64, 3) and canvas.dtype == np.float32
    assert np.abs(canvas - want).max() <= 1 / 255 + 1e-7


def _preds(seed, anchors=60, nc=18):
    """Decoded-output-like rows: xywh around a few centres, scores with ties."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 64, (anchors, 2))
    wh = rng.uniform(2, 30, (anchors, 2))
    cls = np.round(rng.uniform(0, 1, (anchors, nc)), 2)  # rounded: ties
    return np.concatenate([xy, wh, cls], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_and_postprocess_equal_uce_tpus(seed):
    pred = _preds(seed)
    boxes, scores = pred[:, :4], pred[:, 4:].max(-1)
    assert yolo.nms(boxes, scores, 0.45) == jyolo.nms(boxes, scores, 0.45)
    assert yolo.nms(boxes[:0], scores[:0]) == jyolo.nms(boxes[:0], scores[:0]) == []
    for thr in (0.2, 0.9, 1.1):
        got = yolo.postprocess(pred, 1.7, 3, 5, score_threshold=thr)
        want = jyolo.postprocess(pred, 1.7, 3, 5, score_threshold=thr)
        assert got == want


def _bad_states(sd):
    dfl = dict(sd)
    dfl["model.22.dfl.conv.weight"] = dfl["model.22.dfl.conv.weight"] * 2
    missing = {k: v for k, v in sd.items() if k != "model.9.cv2.conv.weight"}
    unknown = dict(sd, **{"model.23.conv.weight": np.zeros(1, np.float32)})
    return {"dfl": dfl, "missing": missing, "unknown": unknown}


@pytest.mark.parametrize("case", ["dfl", "missing", "unknown"])
def test_validate_state_rejects_what_uce_tpu_rejects(tiny_state, case):
    sd = _bad_states(tiny_state)[case]
    with pytest.raises(ValueError) as want:
        jyolo.validate_state(sd)
    with pytest.raises(ValueError) as got:
        yolo.validate_state(sd)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        yolo.validate_state({k: torch.from_numpy(v) for k, v in sd.items()})
    yolo.validate_state(tiny_state)
